"""Smoke run of the PyTorch/CUDA port (`ns2vc_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from `ns2vc_tpu_torch/csrc/` (one nvcc per
source, in parallel), holds each against its plain PyTorch version at the
shapes the path gives it (K1 also at ContentVec's (1, 12, T, 64) f32
shapes), checks the full-width model and the audio front end (resampling,
log-mel, ContentVec, CREPE) on the card against the CPU, and drives the
port at full width in bf16: `Svc.infer_batch` / `infer_from_features`
serving, the ddim / dpmsolver / unipc samplers, the readback overlap of
`infer_batch_async`, the MicroBatcher, and wav in -> wav out through the
port CLI's `main` (unipc, and CREPE F0 with -fmp), with launch counters
that show each path went through both kernels, each by the route its dtype
takes. Last, one serving call at B=16 and one at B=1 run under
torch.profiler: device time by kernel and the device's busy share (last,
because the profiler slows the launches of what runs after it). Weights
are random from a seed and the audio is synthesized. Every phase passes or
the script exits non-zero; there is no CPU fallback. It imports nothing of
JAX or of the JAX package.

Parity phases run with TF32 off; the serving and CLI phases run with
PyTorch's defaults.

Every serving call goes through `Svc`'s serving programs: a key's first
call runs the eager body once (the warm-up), captures it as a CUDA graph
and replays it; later calls replay. So the serving phases count a first
call's launches twice (warm-up and replay) and a later call's once, and
the CLI runs (a fresh Svc each) count each device batch twice. The
compiled serving phase (after the MicroBatcher, whose dispatches must
each be one replay, and whose program cache's memory is printed) holds
each program against the eager body (`Svc._run_eager`) at the same seed,
bit for bit: B=16 bf16 pcm16, B=1 bf16 f32 out, B=16 f32, DDIM with eta >
0 and DDPM (a 25-step copy of the model), whose per-step noise is drawn
before the replay; it times eager against graph in turns (eager, graph,
graph, eager), dispatches two batches of one key in flight and reads each
back, and prints each program's capture time, graph nodes and replays.
Each of the three programs' graphs must hold, as kernel nodes read
through libcuda, exactly the K1, K2 and statistics launches its replay
adds to the counters. The profiles at the end also profile the eager body
of the same three calls (kernel time and busy share of each), and each
profiled replay's K1, K2 and statistics kernels, as the profiler saw them,
must be the launches the counters counted (a profile that lost kernel
records, which the eager bodies' profiles show happens, is taken again,
at most three times). A JSON line {"compiled_serving": {...}}
holds these numbers, and each route's kernels-line entry gains
`compiled_serving_launches`.

Training (after the CLI runs): 12 synthesized wavs through the port's
preprocess on the card (ContentVec through K1's f32 route), then
`Config()` at full width trained through the `Trainer` at 32 x 272 in bf16
with remat dots: launches and backward calls of one step, counted with
the counts set to 0 just before it (each K1 / K2 call of the forward
launches again in the recomputation, and has one backward); step time and
peak memory for remat dots, off and all; the loss on one fixed batch over
30 steps; the loader-fed loop; every K1 / K2 geometry of a step, forward
and backward through the autograd Functions, against autograd through the
plain versions, with the torch backward's device time and bound; K2's
backward kernels (`affine_silu_conv1d_grad`, csrc/affine_silu_conv1d_bwd.cu)
at every geometry of the step, in bf16 and in f32, against the plain
backward (cuDNN, TF32 off; the bf16 kernels' f32 sums before rounding)
within K2_BWD_RTOL of max|plain| per gradient, two launches bitwise equal,
timed in turns against cuDNN's path under the step's flags and under
cudnn.deterministic; a step's launches of the backward kernels (45 bf16,
one per K2 backward); card vs
CPU gradients at B=2 x 272 in f32 and bf16 vs f32 cosines, with a witness
of how far bf16's own rounding moves those cosines (`bf16_witness`; the
phase's batches come in the same order in every run: a serial loader,
then the synced loader for the loop, so the gradients are taken at the
same state every time); a checkpoint round trip and one request served from it. One training step is profiled
with the serving calls at the end. A JSON line {"training": {...}} holds
these numbers, and each route's entry in the kernels line gains the
training step's launches, backward calls, forward and backward device
times and bounds.

The Trainer's steps on the card are replays of its step
programs (one CUDA graph per step key) and its eval sample a replay of an
eval program: the launches per step are a replay's (and an eager step's,
which must launch the same), and the timings above are replays'. The
compiled phases (`check_compiled_training`, also for the F0 predictor's
trainer): first two eager steps from one state under the process's
default flags, the loss, grad norm and every parameter, AdamW moment and
EMA tensor bit for bit (the step is deterministic by itself: K2's
backward kernels, the F0 embedding's one-hot backward, cuDNN's
deterministic algorithms inside the step); then 3 steps through freshly
captured programs against 3 eager steps from the same state and seeds,
under the same default flags: losses, grad norms, the draws (t, noise,
the first dropout mask, the F0 scale) and every parameter, AdamW moment
and EMA tensor, bit for bit; the medians in turns (compiled, eager, eager,
compiled), peak memory beside the graphs' pool, capture ms, graph nodes
and the graph's K1 / K2 / statistics kernel nodes held equal to a
replay's counted launches; two geometries in turns on one memory pool,
each step against the eager step; the capturable AdamW against the eager
one (1e-6); the eval program against the eager eval, bit for bit, with
its first-call, replay and eager ms; a checkpoint loaded into the
compiled trainer recaptures. The profiles at the end take a replay and
an eager step.

F0 predictor (after training): `Config()` with the F0 predictor (seed-0
weights, synthesized contours with unvoiced stretches) served through
`Svc.infer_batch` at B=16 x 400 with auto_predict_f0 off and on, beside the
f0-off model's call (launches: auto off as the f0-off call, the predictor
skipped; auto on +10 K1 on the f32 route, the predictor's f32 trunk), and
at B=1; the CLI with -a on its checkpoint; the PreModel
(content with the F0 embedding, the prediction) and generate_mel card vs
CPU in f32; the prediction in bf16 against f32; K1 at the predictor's
cross-attention geometry; training through the `Trainer` at 32 x 272 (+10
f32 K1 launches and backward calls per step, step time and peak memory beside
the f0-off step, loss_f0 on a fixed batch, card vs CPU gradients of the
predictor, a checkpoint served). Model modules: the encoder op registry's
15 layers at C=256, T=400, B=4 card (f32, bf16) vs CPU with each call's
attention route, K1 at D=128 in f32 and bf16 (each call's route checked), a
classifier-free-guidance UniPC sample through `model_wrapper`, a
LoRA-merged model against a hand merge, and streaming attention and
`ConvFFN.step` against their full-sequence versions. JSON lines
{"f0_predictor": ...} and {"model_modules": ...} hold their numbers, and
each K1 route's entry in the kernels line gains the F0 serving call's
launches and its device time at the predictor's (and D = 128's) geometry.
Each route's entry also gains one B=16 UNet step's calls of it (the f32
routes' at Svc's default f32 serving, whose call at B=16 x 400 is timed
after the bf16 serving calls and profiled at the end).

NSF-HiFiGAN (after the model modules): the community 44.1 kHz generator at
full width (seed-0 weights written in the reference checkpoint's
weight-normed layout with its config.json) converts a synthesized 10 s
48 kHz clip through scripts/torch_reconstruct_nsf.py's main(), twice (ms
per stage: read and resample, log-mel, host DIO, load, generator; no K1 or
K2 launch); the generator alone at B=1 and B=4 x 10 s with PyTorch's TF32
defaults and without TF32 beside its work counted from the code (FLOPs
and convolution activations, and their times at the H100's peaks); and
card vs CPU in f32 without TF32: the generator on 2 s (1e-4), both
discriminators and the three GAN losses at 2 x 8192 (1e-4 relative). A
JSON line {"nsf_hifigan": {...}} holds these numbers.

Data parallel (after NSF-HiFiGAN): the Trainer over torch.distributed, its
ranks started as subprocesses of this script (`--data-parallel-worker`)
through NS2VC_COORDINATOR. First one process over NCCL at full width
(Config(), 32 x 272, bf16, remat dots, the synced loader, serial, on the
training phase's features): launches and backward calls of one step, which must be
the single-process step's, its all-reduces (one, of every gradient and
the loss terms in f32), the median step of 12 after 3 warm-up beside the
training phase's single-process step, the all-reduce alone. Then two ranks
on the one card over gloo (NCCL takes one rank per device; gloo reduces
a host copy) at reduced depth (encoders 1 layer, UNet levels 128 and 256),
f32 without TF32 (both kernels' f32 routes), dropout 0, batch 4 per rank,
content buckets 192 and 272: after 3 steps the ranks' parameters and first
gradients are bitwise equal; one process on the concatenated batches (the
same t and noise: the step's generator at the global batch's shape) gives
the same losses (rtol 2e-5), grad norms (2e-4) and first gradients (rtol
1e-3, atol 1e-7: JAX's tolerances for this comparison); both ranks run the
same bucket geometries; rank 0 saves, both resume at the saved step with
equal parameters and train on. A JSON line {"data_parallel": {...}} holds
these numbers.

The main path is the wav-in -> wav-out CLI run (unipc, bf16): its launch
counts are read around it, and every K1 / K2 call it makes is recorded by
geometry (shape, strides, key bias, dtype), and each geometry is then held
against the plain version in f32 and in bf16. The same conversion in f32
with TF32 off runs once through the kernels and once through their plain
versions, and the two waveforms are compared.

Each kernel has two routes, chosen by dtype in its wrapper: bf16 goes to
the bf16 tensor-core kernels (`flash_attention_tc`: the wgmma kernel over
TMA-fed K/V tiles, `flash_attention_tc_wgmma`, the single-query kernel
for calls of one query (the two attention pools), `flash_attention_tc_q1`,
and for other rows TMA cannot take the mma.sync kernel with element
loads, `flash_attention_tc_narrow`; every K1 bf16 geometry also times the
mma.sync kernel it replaced, in turns, and prints the exp floor;
`affine_silu_conv1d_tc`: wgmma over TMA-fed weights, with its element-load
sub-route `affine_silu_conv1d_tc_elem` for x that TMA cannot describe),
f32 to the 3xTF32 tensor-core ones (`flash_attention_f32tc`: the tf32
wgmma kernel over TMA-fed K/V tiles, `flash_attention_f32tc_wgmma`, timed
at every f32 geometry in turns against the mma.sync 3xTF32 kernel it
replaced, which keeps the rows TMA cannot take,
`flash_attention_f32tc_narrow`, and held to give bitwise-equal outputs on
two launches; its calls of one query take the single-query kernel in f32,
`flash_attention_f32tc_q1`, timed in turns against the wgmma kernel;
`affine_silu_conv1d_f32tc`: wgmma, three TF32 passes per product, with
`affine_silu_conv1d_f32tc_elem` for x that TMA cannot describe; every f32
K2 geometry must give bitwise-equal outputs on two launches). The
GroupNorm statistics and fold before every K2 call are one kernel for both
dtypes (`group_norm_affine`): at every K2 geometry it is held against
`group_norm_affine_plain` within GN_RTOL and two launches must agree bit
for bit, timed beside torch.var_mean over the f32 grouped view and its
bound. Every route is held against the plain version at the B=16 serving
shapes and at every geometry the CLI run recorded, in its own dtype's
tolerance (the calls of one query in both dtypes).

Output: one line per phase result (every timing line ends with the card's
name and power limit), then a JSON line {"kernels": [...]}, one entry per
route: launches (counted in the bf16 CLI run, or for the f32 resnet route
and the f32 single-query route, which that run does not take, in the f32
CLI run through the kernels; `launches_from` names the run); max_abs_err,
the largest error against the plain version over every shape checked in
the route's dtype; ms / plain_ms,
the CLI run's calls of the route, each geometry's device time (10 calls
captured as a CUDA graph, the replay timed with CUDA events) times its
calls, summed, and eager_ms, the same with the calls made back to back
from Python (which at most of these shapes times the host's launches);
bound_ms, the same sum of each geometry's least time on an H100 SXM: the
larger of its FLOPs over the peak rate of its type (989 TFLOP/s bf16
tensor cores; f32 at f32 accuracy, 3 TF32 passes at 494.7 TFLOP/s) and its
bytes (each input read once, each
output written once) over 3.35 TB/s, with bound_by the term that bounds
the most of that sum;
library_ms, the same sum for one PyTorch call of the same function
(`F.scaled_dot_product_attention` with the additive key bias for K1; none
for K2, whose affine -> SiLU -> conv has no single call: `conv_alone_ms`
times cuDNN's conv1d of the pre-activated input beside it; torch.var_mean
alone for the statistics). K2's backward kernels have entries of their
own, `affine_silu_conv1d_backward_bf16` and `_f32`: launches counted in
one training step (bf16) and in the f32 card gradients, the errors
against the plain backward (`max_abs_err`, and `max_rel_err` of
max|plain|), ms, plain_ms (cuDNN's path under the step's flags) and
plain_deterministic_ms summed over the training step's geometries,
bound_ms, and library_ms null (cuDNN's `convolution_backward` computes
neither the activation's gradient nor da, db). The serving profiles at
the end name K1's, K2's
and the statistics kernel's share of each call, and the kernels of one
B=16 UNet step's 45 epilogues are counted with the statistics as torch ops
and through their kernel. Then the card's name and power limit, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter, defaultdict

import numpy as np

B, T_CLIP, TP_REFER, STEPS = 16, 400, 272, 50  # the serving workload
T_PAD, TP_PAD = 448, 320                       # their 64-frame buckets
SEED = 0

# f32 (TF32 off): the kernels and the plain versions sum in other orders
ATTN_F32_ATOL = 2e-5       # the JAX suite's bound for the Pallas kernel
RESNET_F32_ATOL = 3e-5     # the JAX suite's bound: sums of up to 3*1024
                           # products of O(1) terms, 3xTF32 on the card
# bf16: K1's plain version rounds the probabilities to bf16 before the PV
# product and the kernel keeps them f32 (the JAX suite's bf16 bound is
# 0.03); K2's two sides differ in summation order before one bf16 rounding
ATTN_BF16_ATOL = 3e-2
RESNET_BF16_RTOL = 1e-2    # of max |plain|, floored at 1
UNET_ATOL, MODEL_ATOL = 5e-4, 1e-3   # full-width f32, card vs CPU
# front end, f32, card vs CPU: cuDNN / cuFFT against CPU kernels
RESAMPLE_ATOL = 1e-5       # one 171- or 475-tap dot product per sample
MEL_ATOL = 1e-3            # log of a mel power above the 1e-7 clip
CONTENTVEC_ATOL = 1e-3     # 7 convs + 12 layers, as the full model's bound
CREPE_ATOL = 1e-4          # sigmoid probabilities after 6 conv blocks
CONTENTVEC_T = (50, 850, 3000)  # K1 keys: 1 s, 17 s, one unbroken 60 s
CLI_STEPS = 30             # the CLI's default sampling_timesteps
# f32, TF32 off, the CLI's waveform through the kernels vs through their
# plain versions, of max(1, max|wav|): 30 sampler steps carry the one-step
# error (MODEL_ATOL's bound) forward, and ContentVec's into the content
CLI_WAV_ATOL = 1e-3
CARD = ""                  # nvidia-smi's name and power limit, set in main
SM_CLOCK_MHZ = 0.0         # nvidia-smi's clocks.max.sm, set in main
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W) for bound_ms. The
# f32 routes are held to f32 accuracy, which the card reaches at most
# through three TF32 tensor-core passes (3xTF32) at 494.7 TFLOP/s: the
# least time of an f32 product is 3 x its FLOPs at that rate (the f32 CUDA
# cores' 67 TFLOP/s is slower)
PEAK_TF32 = 494.7e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": PEAK_TF32 / 3}
PEAK_F32_CORES = 67e12     # f32 outside the tensor cores (the statistics)
PEAK_BYTES = 3.35e12
# the GroupNorm statistics kernel against its plain version, f32 either way
# (other summation orders): of max(1, max|a|, max|b|)
GN_RTOL = 2e-5
# K2's backward kernels against the plain backward (cuDNN, TF32 off), f32
# sums in other orders, the bf16 kernels' sums before their rounding: each
# of dx, da, db, dw, dbias within K2_BWD_RTOL of its max |plain| (K2's f32
# bound)
K2_BWD_RTOL = 3e-5
# K2's backward kernels (csrc/affine_silu_conv1d_bwd.cu), per dtype: the
# backward of the TPU kernel, which XLA differentiates
BACKWARD_ROUTES = {
    "affine_silu_conv1d_backward_bf16": (
        "affine_silu_conv1d_bwd.cu", "ns2vc_tpu/ops/pallas_resnet.py:71"),
    "affine_silu_conv1d_backward_f32": (
        "affine_silu_conv1d_bwd.cu", "ns2vc_tpu/ops/pallas_resnet.py:71"),
}
ROUTES = {   # route -> (kernel source, the TPU code it replaces)
    # the f32 route as a whole (its sub-routes below), named by its main
    # kernel's source
    "flash_attention_f32tc": ("flash_attention_f32_wgmma.cu",
                              "ns2vc_tpu/ops/pallas_attention.py:92"),
    # its sub-route on the path: the tf32 wgmma kernel over TMA-fed K/V
    # tiles. The mma.sync 3xTF32 kernel ("flash_attention_f32tc_narrow",
    # flash_attention.cu) takes f32 rows TMA cannot take of more than one
    # query; no path has such calls, so it is not listed here: its cp.async
    # form is held against its plain version and timed in turns beside the
    # wgmma kernel at every f32 geometry (`k1_case`), and its element-load
    # form, as the route runs it, at two head views one float longer per
    # row (`check_attention`)
    "flash_attention_f32tc_wgmma": ("flash_attention_f32_wgmma.cu",
                                    "ns2vc_tpu/ops/pallas_attention.py:92"),
    # the bf16 route as a whole (both sub-routes below), named by its main
    # kernel's source
    "flash_attention_tc": ("flash_attention_wgmma.cu",
                           "ns2vc_tpu/ops/pallas_attention.py:92"),
    # its sub-routes on the path: the wgmma kernel, and the single-query
    # kernel (Tq == 1: the attention pools). The mma.sync kernel with
    # element loads ("flash_attention_tc_narrow", flash_attention_tc.cu)
    # takes rows TMA cannot take of more than one query; no path has such
    # calls since the pools took the single-query kernel, so it is held
    # against its plain version and timed at the pools' geometries beside
    # the kernel that replaced it there (`k1_case`), not listed here
    "flash_attention_tc_wgmma": ("flash_attention_wgmma.cu",
                                 "ns2vc_tpu/ops/pallas_attention.py:92"),
    "flash_attention_tc_q1": ("flash_attention_q1.cu",
                              "ns2vc_tpu/ops/pallas_attention.py:92"),
    # the f32 route's calls of one query take the same kernel in f32
    "flash_attention_f32tc_q1": ("flash_attention_q1.cu",
                                 "ns2vc_tpu/ops/pallas_attention.py:92"),
    "affine_silu_conv1d_f32tc": ("gn_silu_conv1d.cu",
                                 "ns2vc_tpu/ops/pallas_resnet.py:71"),
    "affine_silu_conv1d_tc": ("gn_silu_conv1d_tc.cu",
                              "ns2vc_tpu/ops/pallas_resnet.py:71"),
    # the XLA reductions of the Pallas kernel's wrapper (:121-132)
    "group_norm_affine": ("group_norm_affine.cu",
                          "ns2vc_tpu/ops/pallas_resnet.py:121"),
}


@contextlib.contextmanager
def no_tf32():
    """f32 parity: cuBLAS and cuDNN without TF32, restored afterwards."""
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def wall_ms(fn):
    """Host wall time of fn() between two device synchronisations."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10) -> float:
    """Device time of fn(): `iters` calls captured as one CUDA graph, the
    replay timed with CUDA events, per call. Eager back-to-back calls
    measure the host's launch rate whenever a call's device work is shorter
    than its Python and launch cost, as at most of the path's shapes; the
    graph replays the same kernels without the host. Falls back to
    time_ms (and says so) if the capture fails."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        say(f"  (graph capture failed, eager timing: {str(e)[:120]})")
        return time_ms(fn)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(2):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (2 * iters)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi: {out.returncode} {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (IndexError, ValueError):
        fail(f"nvidia-smi clocks.max.sm: {out.returncode} {out.stdout!r} "
             f"{out.stderr.strip()}")


def exp_floor(q, k) -> float:
    """The least time (ms) the H100's special-function units take for a K1
    call's exponentials: one per score, 16 per SM and clock on 132 SMs at
    the card's top SM clock (SM_CLOCK_MHZ)."""
    b, h, tq, _ = q.shape
    return b * h * tq * k.shape[2] / (132 * 16 * SM_CLOCK_MHZ * 1e6) * 1e3


def bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    """The least time (ms) an H100 SXM could take, and which term sets it."""
    f = flops / PEAK_FLOPS[str(dtype)[6:]]
    m = nbytes / PEAK_BYTES
    return max(f, m) * 1e3, ("operations" if f >= m else "bytes")


def k1_bound(q, k, bias):
    b, h, tq, d = q.shape
    tk = k.shape[2]
    nbytes = q.element_size() * (2 * b * h * tq * d + 2 * b * h * tk * d)
    return bound(4.0 * b * h * tq * tk * d,
                 nbytes + (0 if bias is None else 4 * b * tk), q.dtype)


def k2_bound(bsz, t, c, co, dtype):
    es = 2 if str(dtype) == "torch.bfloat16" else 4
    nbytes = es * (bsz * t * c + 3 * co * c + co + bsz * t * co) + 8 * bsz * c
    return bound(6.0 * bsz * t * c * co, nbytes, dtype)


def gn_bound(bsz, t, c, dtype, pdtype, film):
    """The statistics kernel's least time: x read once, gamma / beta (and
    FiLM) read, a and b written; ~4 f32 operations per element of x on
    the CUDA cores."""
    es = 2 if str(dtype) == "torch.bfloat16" else 4
    pe = 2 if str(pdtype) == "torch.bfloat16" else 4
    nbytes = es * bsz * t * c + pe * (2 * c + (2 * bsz * c if film else 0)) \
        + 8 * bsz * c
    f, m = 4.0 * bsz * t * c / PEAK_F32_CORES, nbytes / PEAK_BYTES
    return max(f, m) * 1e3, ("operations" if f >= m else "bytes")


def gn_route(dtype) -> str:
    """The statistics kernel's entry in the sums: bf16 x (the main path's)
    under its kernels-line name, f32 x apart."""
    return ("group_norm_affine" if str(dtype) == "torch.bfloat16"
            else "group_norm_affine_f32")


def k1_route(dtype) -> str:
    from ns2vc_tpu_torch.ops.flash_attention import attention_route

    return f"flash_attention_{attention_route('cuda', dtype)}"


def k2_route(dtype) -> str:
    from ns2vc_tpu_torch.ops.fused_resnet import resnet_route

    return f"affine_silu_conv1d_{resnet_route('cuda', dtype)}"


def sdpa_call(q, k, v, bias, scale):
    """The library yardstick of K1: one SDPA call with the additive key
    bias as its mask (timed only; the port never calls it)."""
    import torch.nn.functional as F

    mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=scale)


def sdpa_backend(q, k, v, bias, scale) -> str:
    """Which SDPA backend the dispatcher picks for these inputs."""
    import torch

    mask = None if bias is None else bias.to(q.dtype)[:, None, None, :]
    try:
        from torch.nn.attention import SDPBackend

        return SDPBackend(torch._fused_sdp_choice(
            q, k, v, mask, 0.0, False, scale=scale)).name
    except (AttributeError, ImportError, RuntimeError, TypeError,
            ValueError) as e:
        return f"unknown ({type(e).__name__})"


def reset_launches() -> None:
    from ns2vc_tpu_torch.ops import flash_attention, fused_resnet

    flash_attention.reset_launches()
    fused_resnet.reset_launches()


def route_counts() -> dict:
    """Launches per route since the last reset_launches() (a sub-route's
    launches also count in its route's)."""
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention
    from ns2vc_tpu_torch.ops.fused_resnet import (
        affine_silu_conv1d, group_norm_affine,
    )

    k1, k2 = flash_attention.route_launches, affine_silu_conv1d.route_launches
    return {"flash_attention_f32tc": k1["f32tc"] + k1["f32tc_narrow"]
            + k1["f32tc_q1"],
            "flash_attention_f32tc_wgmma": k1["f32tc"],
            "flash_attention_f32tc_narrow": k1["f32tc_narrow"],
            "flash_attention_f32tc_q1": k1["f32tc_q1"],
            "flash_attention_tc": k1["tc"] + k1["tc_narrow"] + k1["tc_q1"],
            "flash_attention_tc_wgmma": k1["tc"],
            "flash_attention_tc_narrow": k1["tc_narrow"],
            "flash_attention_tc_q1": k1["tc_q1"],
            "affine_silu_conv1d_f32tc": k2["f32tc"] + k2["f32tc_elem"],
            "affine_silu_conv1d_f32tc_elem": k2["f32tc_elem"],
            "affine_silu_conv1d_tc": k2["tc"] + k2["tc_elem"],
            "affine_silu_conv1d_tc_elem": k2["tc_elem"],
            "group_norm_affine": group_norm_affine.launches}


def route_totals(counts: dict) -> dict:
    """Launches per route without the counts of K1's wgmma kernels, each
    its route's (bf16 "tc", f32 "f32tc") less its narrow and single-query
    launches (`k1_split` predicts the bf16 route's three from a run's
    recorded calls); fails if they do not add up."""
    for dt in ("", "f32"):
        route = f"flash_attention_{dt}tc"
        total, narrow = counts[route], counts.get(f"{route}_narrow")
        wgmma = counts[f"{route}_wgmma"]
        q1 = counts.get(f"{route}_q1", 0)
        # backward_calls() does not count the narrow sub-routes apart
        if (wgmma > total) if narrow is None else (
                wgmma + narrow + q1 != total):
            fail(f"K1 {dt or 'bf16'} sub-routes do not add up to its "
                 f"{total} launches: {counts}")
    return {k: n for k, n in counts.items()
            if k not in ("flash_attention_tc_wgmma",
                         "flash_attention_f32tc_wgmma")}


def k1_split(calls) -> dict:
    """The bf16 K1 launches per sub-route of the calls a PathCalls
    recorded, as `_launch` routes them: one query (Tq == 1, at most
    Q1_MAX_KEYS keys) to the single-query kernel, else q, k and v in whole
    aligned 16-byte rows (D % 8 == 0, offsets and strides of 8 elements)
    to the wgmma kernel, the others to tc_narrow."""
    import torch

    from ns2vc_tpu_torch.ops.flash_attention import Q1_MAX_KEYS

    out = {"flash_attention_tc_wgmma": 0, "flash_attention_tc_narrow": 0,
           "flash_attention_tc_q1": 0}
    for (geo, dtype, _, _), n in calls.k1.items():
        if dtype != torch.bfloat16:
            continue
        (q_shape, *_), (k_shape, *_) = geo[:2]
        aligned = all(
            shape[-1] % 8 == 0 and offset % 8 == 0
            and all(s % 8 == 0 for s, m in zip(stride[:-1], shape) if m > 1)
            for shape, stride, offset, _ in geo)
        out["flash_attention_tc_q1" if q_shape[2] == 1
            and k_shape[2] <= Q1_MAX_KEYS else "flash_attention_tc_wgmma"
            if aligned else "flash_attention_tc_narrow"] += n
    return out


class MmaSyncLibrary:
    """The kernel library with the wgmma kernels' entries answered by the
    mma.sync kernels they replaced, with 16-byte cp.async tiles: bf16's by
    flash_attention_tc.cu (the same arguments, its `vec` = 1 in place of
    the key tile), f32's by flash_attention.cu (`vec` = 1, its own key
    split `plan_f32tc` in place of the wgmma plan, and its workspace):
    under `mma_sync_kernel()` the wrapper's "tc" and "f32tc" calls run
    the kernel the wgmma one replaced, at about the same Python cost."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def ns2vc_flash_attention_wgmma_fwd(self, *args):
        return self.lib.ns2vc_flash_attention_tc_fwd(*args[:-2], 1, args[-1])

    def ns2vc_flash_attention_f32_wgmma_fwd(self, *args):
        import torch

        from ns2vc_tpu_torch.ops.flash_attention import plan_f32tc

        b, h, tq, tk, d = args[5:10]
        splits, per = plan_f32tc(b * h, tq, tk, d)
        ws = [None, None] if splits == 1 else [
            torch.empty((splits, b * h * tq, n), dtype=torch.float32,
                        device="cuda") for n in (d, 2)]
        return self.lib.ns2vc_flash_attention_f32tc_fwd(
            *args[:23], 1, per, splits,
            *(None if w is None else w.data_ptr() for w in ws), args[-1])


def q1_off():
    """A context in which K1's calls of one query take the routes they took
    before the single-query kernel: in bf16 the mma.sync kernel with
    element loads at the pools' rows (tc_narrow), in f32 the 3xTF32
    kernel."""
    from unittest import mock

    from ns2vc_tpu_torch.ops import flash_attention as fa

    return mock.patch.object(fa, "Q1_DTYPES", ())


def mma_sync_kernel():
    """A context in which K1's "tc" (bf16) and "f32tc" (f32) calls launch
    the mma.sync kernels the wgmma ones replaced."""
    from unittest import mock

    from ns2vc_tpu_torch.ops import _build

    proxy = MmaSyncLibrary(_build.library())
    return mock.patch.object(_build, "library", lambda: proxy)


# -- the path's shapes ------------------------------------------------------

def attention_cases(cfg, bsz=B):
    """(name, B, H, Tq, Tk, D, valid keys or None, calls per UNet step,
    layout) of every attention the serving path runs at batch `bsz`.
    layout: 'self' reads q/k/v from one packed (B, T, 3C) projection,
    'cross' q from (B, Tq, C) and k/v from (B, Tk, C)."""
    d = cfg.diffusion_encoder
    enc = cfg.phoneme_encoder
    lpb, n = d.layers_per_block, len(d.block_out_channels)
    out = []
    for lvl, ch in enumerate(d.block_out_channels):
        t = T_PAD // 2 ** lvl
        # self/cross calls per step at this level: down (not the last
        # level), mid (last level), up (all but the first up block)
        calls = (lpb if lvl < n - 1 else 1) + (lpb + 1 if lvl < n - 1 else 0)
        hd = ch // d.n_heads
        out.append((f"unet_self_L{lvl}", bsz, d.n_heads, t, t, hd, None,
                    calls, "self"))
        out.append((f"unet_cross_L{lvl}", bsz, d.n_heads, t, TP_PAD, hd,
                    TP_REFER, calls, "cross"))
    hd = enc.hidden_channels // enc.n_heads
    out.append(("enc_content_self", bsz, enc.n_heads, T_PAD, T_PAD, hd, T_CLIP,
                0, "self"))
    out.append(("enc_prompt_self", bsz, enc.n_heads, TP_PAD, TP_PAD, hd,
                TP_REFER, 0, "self"))
    pr = cfg.prompt_encoder.in_channels
    out.append(("pool_ref_enc", bsz, 1, 1, TP_PAD + 1, pr, None, 0, "cross"))
    out.append(("pool_add_embedding", bsz, d.addition_embed_heads, 1,
                TP_PAD + 1, d.hidden_channels // d.addition_embed_heads,
                None, 0, "cross"))
    for t in CONTENTVEC_T:   # ContentVec: 12 heads of 64 over T50 frames
        out.append((f"contentvec_T{t}", 1, 12, t, t, 64, None, 0, "cross"))
    return out


def resnet_cases(unet):
    """(name, T, C, Co, film) of both epilogues of every resnet block, and
    the output tail, at the serving bucket."""
    from ns2vc_tpu_torch.models.unet import ResnetBlock1D

    n = len(unet.chans)
    out = []
    for name, m in unet.named_children():
        if not isinstance(m, ResnetBlock1D):
            continue
        part, lvl = name.split("_")[:2]
        level = n - 1 if part == "mid" else (
            int(lvl) if part == "down" else n - 1 - int(lvl))
        t = T_PAD // 2 ** level
        cin, co = m.conv1.in_channels, m.conv1.out_channels
        out.append((f"{name}.1", t, cin, co, False))
        out.append((f"{name}.2", t, co, co, True))
    out.append(("conv_out", T_PAD, unet.chans[0],
                unet.conv_out.out_channels, False))
    return out


# -- phases -----------------------------------------------------------------

K1_SUB = {"tc": "flash_attention_tc_wgmma",      # bf16 sub-route entries
          "tc_narrow": "flash_attention_tc_narrow",
          "tc_q1": "flash_attention_tc_q1",
          "f32tc": "flash_attention_f32tc_wgmma",   # and f32's
          "f32tc_narrow": "flash_attention_f32tc_narrow",
          "f32tc_q1": "flash_attention_f32tc_q1"}


def k1_case(q, k, v, bias, scale=None, timed=True):
    """K1 against its plain version on one input set, through the route its
    dtype takes. Returns a dict: route, sub (the sub-route: K1_SUB's
    entry), err, tol, bound, bound_by, and when timed exp (`exp_floor`)
    and the device times (graph_ms) ms, plain, lib (SDPA; at the narrow
    sub-routes on contiguous copies), old (the
    mma.sync kernel of the dtype, in turns with the wgmma kernel, or in
    bf16 with the single-query kernel, where those run: old, new, new,
    old), prior (f32 single query: the 3xTF32 wgmma kernel, in turns
    likewise), and eager, the kernel's eager time_ms; the times None when
    not timed; when timed also old_err, the replaced kernel's error against
    the plain version, which must be within tol as well. The f32 wgmma
    kernel must give bitwise-equal outputs on two launches."""
    import torch

    from ns2vc_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain,
    )

    before = dict(flash_attention.route_launches)
    got = flash_attention(q, k, v, bias, scale)
    sub = next((key for key, n in flash_attention.route_launches.items()
                if n != before[key]), None)
    if sub == "f32tc" and not torch.equal(
            got, flash_attention(q, k, v, bias, scale)):
        fail(f"K1 f32 wgmma kernel at q {tuple(q.shape)} k "
             f"{tuple(k.shape)}: two launches differ")
    want = flash_attention_plain(q, k, v, bias, scale)
    torch.cuda.synchronize()
    r = {"route": k1_route(q.dtype), "sub": K1_SUB.get(sub),
         "err": (got.float() - want.float()).abs().max().item(),
         "tol": ATTN_F32_ATOL if q.dtype == torch.float32 else ATTN_BF16_ATOL,
         "ms": None, "plain": None, "lib": None, "eager": None,
         "exp": exp_floor(q, k) if timed else None}
    r["bound"], r["bound_by"] = k1_bound(q, k, bias)
    if timed:
        s = q.shape[-1] ** -0.5 if scale is None else scale
        call = lambda: flash_attention(q, k, v, bias, scale)  # noqa: E731
        if sub in ("tc", "f32tc", "tc_q1", "f32tc_q1"):
            # against the kernel it replaced, in turns (old, new, new, old),
            # held against the plain version too: the mma.sync kernel of the
            # dtype, or for calls of one query the route they took before
            before = mma_sync_kernel if sub in ("tc", "f32tc") else q1_off
            with before():
                before_out = flash_attention(q, k, v, bias, scale)
                torch.cuda.synchronize()
                r["old_err"] = (before_out.float()
                                - want.float()).abs().max().item()
                if not r["old_err"] <= r["tol"]:
                    fail(f"K1 {str(q.dtype)[6:]} at q {tuple(q.shape)} k "
                         f"{tuple(k.shape)}: the kernel {r['sub']} replaced "
                         f"errs by {r['old_err']} > {r['tol']}")
                t0 = graph_ms(call)
            r["ms"] = (graph_ms(call) + graph_ms(call)) / 2
            with before():
                r["prior" if sub == "f32tc_q1" else "old"] = \
                    (t0 + graph_ms(call)) / 2
        else:
            r["ms"] = graph_ms(call)
            if sub in ("tc_narrow", "f32tc_narrow"):   # the mma.sync kernel
                r["old"] = r["ms"]
        r["eager"] = time_ms(call)
        r["plain"] = graph_ms(lambda: flash_attention_plain(q, k, v, bias,
                                                            scale))
        # SDPA refuses rows that are not 16-byte aligned: at the narrow
        # sub-routes it reads contiguous copies of the same values
        lib_in = ([x.contiguous() for x in (q, k, v)]
                  if str(sub).endswith("_narrow") else (q, k, v))
        r["lib"] = graph_ms(sdpa_call(*lib_in, bias, s))
    return r


def k2_case(bsz, t, c, co, film, dtype, g, dev, timed=True):
    """K2 against its plain version on random inputs of one geometry, the
    affine folded from a GroupNorm (with FiLM if `film`), through the route
    its dtype takes. Returns a dict: route, err, tol, bound, bound_by, and
    when timed the device times (graph_ms) ms, plain, conv (cuDNN's conv1d
    of the pre-activated input alone), and eager, the kernel's eager
    time_ms; the times None when not timed. Its "stats" entry holds the
    same for the statistics kernel that folded the affine (err against
    `group_norm_affine_plain`, lib: torch.var_mean over the f32 grouped
    view alone); fails unless two launches give bitwise-equal a, b within
    GN_RTOL of the plain version's, and in f32 unless two launches of the
    conv give bitwise-equal y (its split sums in a fixed order)."""
    import torch
    import torch.nn.functional as F

    from ns2vc_tpu_torch.ops.fused_resnet import (
        affine_silu_conv1d, affine_silu_conv1d_plain, group_norm_affine,
        group_norm_affine_plain,
    )

    x = torch.randn(bsz, t, c, generator=g, device=dev).to(dtype)
    w = (torch.randn(co, c, 3, generator=g, device=dev)
         / (3 * c) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(co, generator=g, device=dev)).to(dtype)
    gamma = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
    beta = 0.1 * torch.randn(c, generator=g, device=dev)
    s = sh = None
    if film:
        s = 0.2 * torch.randn(bsz, c, generator=g, device=dev)
        sh = 0.2 * torch.randn(bsz, c, generator=g, device=dev)
    stats_args = (x, gamma, beta, 8, 1e-5, s, sh)
    a, b = group_norm_affine(*stats_args)
    a2, b2 = group_norm_affine(*stats_args)
    pa, pb = group_norm_affine_plain(*stats_args)
    got = affine_silu_conv1d(x, a, b, w, bias)
    again = affine_silu_conv1d(x, a, b, w, bias)
    want = affine_silu_conv1d_plain(x, a, b, w, bias)
    torch.cuda.synchronize()
    if dtype == torch.float32 and not torch.equal(got, again):
        fail(f"K2 B={bsz} T={t} C={c} Co={co} f32: two launches differ by "
             f"{(got - again).abs().max().item()}")
    st = {"route": gn_route(dtype),
          "err": max((a - pa).abs().max().item(), (b - pb).abs().max().item()),
          "tol": GN_RTOL * max(1.0, pa.abs().max().item(),
                               pb.abs().max().item()),
          "deterministic": torch.equal(a, a2) and torch.equal(b, b2),
          "ms": None, "plain": None, "lib": None, "eager": None}
    if not (st["deterministic"] and st["err"] <= st["tol"]):
        fail(f"GroupNorm statistics B={bsz} T={t} C={c} film={int(film)} "
             f"{dtype}: error {st['err']} (tol {st['tol']}), two launches "
             f"bitwise equal: {st['deterministic']}")
    st["bound"], st["bound_by"] = gn_bound(bsz, t, c, dtype, gamma.dtype,
                                           film)
    if timed:
        xf = x.float().view(bsz, t, 8, c // 8)
        st["ms"] = graph_ms(lambda: group_norm_affine(*stats_args))
        st["eager"] = time_ms(lambda: group_norm_affine(*stats_args))
        st["plain"] = graph_ms(lambda: group_norm_affine_plain(*stats_args))
        st["lib"] = graph_ms(lambda: torch.var_mean(xf, dim=(1, 3),
                                                    correction=0))
    r = {"route": k2_route(dtype), "stats": st,
         "err": (got.float() - want.float()).abs().max().item(),
         "ms": None, "plain": None, "conv": None, "eager": None}
    if dtype == torch.float32:
        r["tol"] = RESNET_F32_ATOL
    else:
        r["tol"] = RESNET_BF16_RTOL * max(1.0, want.float().abs().max().item())
    r["bound"], r["bound_by"] = k2_bound(bsz, t, c, co, dtype)
    if timed:
        r["ms"] = graph_ms(lambda: affine_silu_conv1d(x, a, b, w, bias))
        r["eager"] = time_ms(lambda: affine_silu_conv1d(x, a, b, w, bias))
        r["plain"] = graph_ms(lambda: affine_silu_conv1d_plain(x, a, b, w,
                                                               bias))
        h = F.silu(x.float() * a[:, None, :] + b[:, None, :]).to(
            dtype).transpose(1, 2).contiguous()
        r["conv"] = graph_ms(lambda: F.conv1d(h, w, bias, padding=1))
    return r


class RouteSums:
    """Per route: the worst error and summed times over the shapes given,
    each weighted by its calls."""

    KEYS = ("ms", "eager", "plain", "lib", "conv", "bound", "exp", "old",
            "prior")

    def __init__(self):
        self.err = defaultdict(float)
        self.sums = defaultdict(lambda: defaultdict(float))
        self.by = defaultdict(lambda: defaultdict(float))
        self.calls = defaultdict(int)

    def add(self, r, calls):
        """Under the result's route, and its sub-route where it has one."""
        for route in {r["route"], r.get("sub") or r["route"]}:
            self.err[route] = max(self.err[route], r["err"])
            if r["ms"] is None or calls == 0:
                continue
            self.calls[route] += calls
            for key in self.KEYS:
                if r.get(key) is not None:
                    self.sums[route][key] += calls * r[key]
            self.by[route][r["bound_by"]] += calls * r["bound"]

    def bound_by(self, route):
        by = self.by[route]
        return max(by, key=by.get) if by else None

    def line(self, route):
        s = self.sums[route]
        lib = "var_mean" if route.startswith("group_norm") else "SDPA"
        extra = "".join(f", {name} {s[key]:.4f}" for key, name in (
            ("lib", lib), ("conv", "conv alone")) if key in s)
        exp = f", exp floor {s['exp']:.5f}" if "exp" in s else ""
        old = f" (mma.sync kernel {s['old']:.4f})" if "old" in s else ""
        return (f"device ms: kernel {s['ms']:.4f}{old} (eager "
                f"{s['eager']:.4f}), plain {s['plain']:.4f}{extra}, bound "
                f"{s['bound']:.5f} ({self.bound_by(route)}){exp}")


def check_attention(cfg, dev):
    """Every attention the serving path runs, f32 and bf16, against the
    plain version; the calls of one UNet step at B=16 summed per route (bf16
    serving takes the tensor-core route, f32 serving, `Svc`'s default, the
    3xTF32 one), and in f32 those of one step at B=1 (the single request,
    the CLI's last batch). Returns (every shape's sums, the B=16 step's,
    the B=1 f32 step's)."""
    import torch

    from ns2vc_tpu_torch.ops.attention import split_heads
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention

    g = torch.Generator(device=dev).manual_seed(SEED)
    sums, step, step1 = RouteSums(), RouteSums(), RouteSums()
    cases = [(case, dtype, step) for case in attention_cases(cfg)
             for dtype in (torch.float32, torch.bfloat16)]
    cases += [(case, torch.float32, step1) for case in attention_cases(cfg, 1)
              if case[7] > 0]
    # f32 rows TMA cannot take, as the "f32tc_narrow" route runs them (the
    # mma.sync kernel with element loads, its own key split): head views of
    # a packed projection one float longer per row, at the UNet's first
    # self-attention and at ContentVec's T = 400 (84 blocks: keys split);
    # timed and checked, outside the sums (no path has such calls); their
    # sdpa_ms is SDPA on contiguous copies (`k1_case`)
    cases += [((case[0] + "+1",) + case[1:8] + ("self+1",), torch.float32,
               None) for case in attention_cases(cfg)[:1]]
    cases += [(("contentvec_T400+1", 1, 12, 400, 400, 64, None, 0, "self+1"),
               torch.float32, None)]
    for (name, b, h, tq, tk, d, valid, calls, layout), dtype, at in cases:
        c = h * d
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(dtype)
        if layout == "self":
            q, k, v = rnd(b, tq, 3 * c).split(c, dim=-1)
        elif layout == "self+1":
            q, k, v = rnd(b, tq, 3 * c + 1)[..., :3 * c].split(c, dim=-1)
        else:
            q, k, v = rnd(b, tq, c), rnd(b, tk, c), rnd(b, tk, c)
        q, k, v = (split_heads(x, h) for x in (q, k, v))
        bias = None
        if valid is not None:
            bias = torch.zeros(b, tk, device=dev)
            bias[:, valid:] = -1e4
        r = k1_case(q, k, v, bias)
        # the kernel the call took before, in turns: the mma.sync
        # kernel of its dtype, the 3xTF32 kernel (f32 single query)
        before = "".join(f" {label}={r[key]:.4f}" for key, label in (
            ("old", "mma_sync_kernel_ms"), ("prior", "f32tc_kernel_ms"))
            if r.get(key) is not None)
        say(f"K1 {name:20s} {str(dtype)[6:]:8s} B={b} H={h} Tq={tq} "
            f"Tk={tk} D={d} {r['sub'] or r['route']} max_abs_err="
            f"{r['err']:.3e} (tol {r['tol']:g}) kernel_ms={r['ms']:.4f}"
            f"{before} eager_ms={r['eager']:.4f} plain_ms="
            f"{r['plain']:.4f} sdpa_ms={r['lib']:.4f} bound_ms="
            f"{r['bound']:.5f} ({r['bound_by']}) exp_floor_ms="
            f"{r['exp']:.5f} [{CARD}]")
        if not r["err"] <= r["tol"]:
            fail(f"K1 {name} {dtype}: error {r['err']} > {r['tol']}")
        if at is None:
            if r["sub"] != "flash_attention_f32tc_narrow":
                fail(f"K1 {name} {layout}: took {r['sub']}, not "
                     f"flash_attention_f32tc_narrow")
            continue
        sums.add(r, 1)
        at.add(r, calls)
    qkv = torch.randn(B, T_PAD, 3 * 256, device=dev).bfloat16()
    q, k, v = (split_heads(x, 8) for x in qkv.split(256, dim=-1))
    say(f"K1 SDPA backend at the bf16 encoder self-attention shapes: "
        f"{sdpa_backend(q, k, v, None, 32 ** -0.5)}; with a key bias: "
        f"{sdpa_backend(q, k, v, torch.zeros(B, T_PAD, device=dev), 32 ** -0.5)}")
    # a batch row whose keys are all masked stays finite, on both routes
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(2, 4, 37, 32, generator=g, device=dev).to(dtype)
        k = torch.randn(2, 4, 50, 32, generator=g, device=dev).to(dtype)
        for fill in (-1e4, -1e30):
            bias = torch.zeros(2, 50, device=dev)
            bias[1] = fill
            out = flash_attention(q, k, k, bias)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                fail(f"K1 fully masked row ({dtype}, bias {fill}) is not "
                     f"finite")
    say("K1 fully masked batch rows: finite (f32 and bf16)")
    for bsz, st in ((B, step), (1, step1)):
        for route in st.sums:
            say(f"K1 one UNet step at B={bsz} ({st.calls[route]} calls, "
                f"{route}): {st.line(route)} [{CARD}]")
    return sums, step, step1


def check_resnet(unet, dev):
    """Both epilogues of every resnet block and the output tail at the
    serving bucket, f32 and bf16, against the plain version; the calls of
    one UNet step at B=16 summed per route. Returns (every shape's sums,
    the step's)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cases = resnet_cases(unet) + [("ragged_T", 437, 128, 128, True)]
    sums, step = RouteSums(), RouteSums()
    for name, t, c, co, film in cases:
        for dtype in (torch.float32, torch.bfloat16):
            r = k2_case(B, t, c, co, film, dtype, g, dev)
            say(f"K2 {name:18s} {str(dtype)[6:]:8s} B={B} T={t} C={c} "
                f"Co={co} film={int(film)} {r['route']} max_abs_err="
                f"{r['err']:.3e} (tol {r['tol']:.3g}) kernel_ms={r['ms']:.4f} "
                f"eager_ms={r['eager']:.4f} "
                f"plain_ms={r['plain']:.4f} conv_alone_ms={r['conv']:.4f} "
                f"bound_ms={r['bound']:.5f} ({r['bound_by']}) [{CARD}]")
            if not r["err"] <= r["tol"]:
                fail(f"K2 {name} {dtype}: error {r['err']} > {r['tol']}")
            st = r["stats"]
            say(f"   GroupNorm statistics: max_abs_err={st['err']:.3e} (tol "
                f"{st['tol']:.3g}), two launches bitwise equal; kernel_ms="
                f"{st['ms']:.4f} eager_ms={st['eager']:.4f} plain_ms="
                f"{st['plain']:.4f} var_mean_ms={st['lib']:.4f} bound_ms="
                f"{st['bound']:.5f} ({st['bound_by']})")
            for res in (r, st):
                sums.add(res, 1)
                if name != "ragged_T":
                    step.add(res, 1)
    for route in step.sums:
        say(f"K2 one UNet step at B={B} ({step.calls[route]} calls, "
            f"{route}): {step.line(route)} [{CARD}]")
    return sums, step


class PathCalls:
    """The K1 and K2 calls of one run, grouped by geometry: K1 by the
    shape, strides, storage offset and storage size of q, k and v, the
    dtype, the scale and whether a key bias came (the first call's bias is
    kept), recorded where `multihead_attention` calls it; K2 by (B, T, C),
    the dtype and Co, recorded where the UNet calls `gn_silu_conv1d`. Each
    group counts its calls; the dtype is the second field of every key.
    A serving program's first call makes each call twice, in its eager
    warm-up and in its capture, and launches each twice, in the warm-up and
    the replay that follows: so over a run whose every program is called
    once, as a CLI run's, the calls recorded are the launches made."""

    def __init__(self):
        self.k1: dict = {}     # key -> calls
        self.k2: dict = {}     # key -> calls
        self.bias: dict = {}   # K1 key -> the first call's key bias

    def patches(self):
        from unittest import mock

        import ns2vc_tpu_torch.models.unet as unet
        import ns2vc_tpu_torch.ops.attention as attention

        k1, k2 = attention.flash_attention, unet.gn_silu_conv1d

        def k1_rec(q, k, v, bias=None, scale=None):
            geo = tuple((tuple(t.shape), t.stride(), t.storage_offset(),
                         t.untyped_storage().nbytes() // t.element_size())
                        for t in (q, k, v))
            key = (geo, q.dtype, scale, bias is None)
            if key not in self.k1:
                self.bias[key] = None if bias is None else bias.clone()
            self.k1[key] = self.k1.get(key, 0) + 1
            return k1(q, k, v, bias, scale)

        def k2_rec(x, gamma, beta, w, *args, **kwargs):
            key = (tuple(x.shape), x.dtype, w.shape[0])
            self.k2[key] = self.k2.get(key, 0) + 1
            return k2(x, gamma, beta, w, *args, **kwargs)
        return [mock.patch.object(attention, "flash_attention", k1_rec),
                mock.patch.object(unet, "gn_silu_conv1d", k2_rec)]


def check_path_calls(calls: PathCalls, dev):
    """Every K1 and K2 geometry of a recorded run against its plain
    version, in f32 and in bf16 (each through the route its dtype takes),
    on random inputs laid out as the run's (K1: the same strides and key
    bias). K1 geometries are timed in the dtype the run gave them, and
    those of one query (the pools) in f32 too, under the f32 single-query
    sub-route alone; K2's in both dtypes: the f32 CLI run takes the same
    geometries through the f32 routes. Returns a RouteSums of the run's
    calls."""
    from unittest import mock

    import torch

    import ns2vc_tpu_torch.ops.fused_resnet as fr

    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    sums = RouteSums()

    def k1(key, dtype, timed):
        geo, _, scale, _ = key
        q, k, v = (torch.randn(size, generator=g, device=dev).to(dtype)
                   .as_strided(shape, stride, offset)
                   for shape, stride, offset, size in geo)
        return k1_case(q, k, v, calls.bias[key], scale, timed)

    def k2(key, dtype, timed):
        (bsz, t, c), _, co = key
        return k2_case(bsz, t, c, co, True, dtype, g, dev, timed)

    def k1_label(key):
        (q, *_), (k, *_) = key[0][:2]
        return f"q{q} k{k} bias={int(not key[3])}"

    def k2_label(key):
        (bsz, t, c), _, co = key
        return (f"B={bsz} T={t} C={c} Co={co} split bf16 "
                f"{fr.plan_wgmma(bsz, t, c, co)} f32 {fr.plan_tc(bsz, t, c, co)}")
    def single(key):   # a K1 geometry of one query
        return key[0][0][0][2] == 1
    for name, groups, run, label, timed_in in (
            ("K1", calls.k1, k1, k1_label,
             lambda d, key: d == key[1] or single(key)),
            ("K2", calls.k2, k2, k2_label, lambda d, key: True)):
        for key, n in groups.items():
            parts = []
            for dtype in (torch.float32, torch.bfloat16):
                r = run(key, dtype, timed_in(dtype, key))
                if not r["err"] <= r["tol"]:
                    fail(f"{name} CLI geometry {label(key)} {dtype}: error "
                         f"{r['err']} > {r['tol']}")
                if name == "K1" and dtype != key[1] and r["sub"]:
                    # the f32 CLI run's calls of this geometry: timed
                    # under the sub-route only (the route's sums are the
                    # bf16 run's calls)
                    sums.add({**r, "sub": None, "ms": None}, n)
                    sums.add({**r, "route": r["sub"]}, n)
                else:
                    sums.add(r, n)
                if "stats" in r:
                    sums.add(r["stats"], n)
                parts.append(f"{str(dtype)[6:]} {r['route']} err "
                             f"{r['err']:.2e}" + ("" if r["ms"] is None else
                                                  f" ms={r['ms']:.4f} plain="
                                                  f"{r['plain']:.4f} bound="
                                                  f"{r['bound']:.5f}"))
            say(f"{name} CLI {label(key)} x{n} (run in {str(key[1])[6:]}): "
                + "; ".join(parts))
    for route in sorted(sums.sums):
        say(f"{route} over the CLI run's {sums.calls[route]} calls: worst "
            f"error {sums.err[route]:.3e}; {sums.line(route)} [{CARD}]")
    # K2's channel split against none, on the CLI run's bf16 geometries
    split_ms = unsplit_ms = 0.0
    for key, n in calls.k2.items():
        (bsz, t, c), _, co = key
        if fr.plan_wgmma(bsz, t, c, co)[0] == 1:
            continue
        split_ms += n * k2(key, torch.bfloat16, True)["ms"]
        with mock.patch.object(fr, "plan_wgmma",
                               lambda b_, t_, c_, co_: (1, -(-c_ // fr.TC_BK))):
            unsplit_ms += n * k2(key, torch.bfloat16, True)["ms"]
    say(f"affine_silu_conv1d_tc channel split on the CLI run's split "
        f"geometries: planned {split_ms:.2f} ms, unsplit {unsplit_ms:.2f} ms "
        f"[{CARD}]")
    return sums


def check_full_model(cfg, sd, vsd, dev):
    """Full width, f32, TF32 off: encode, precompute, one denoise and a
    Vocos decode on the card (kernels) against the CPU (plain versions)."""
    import torch

    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.models.vocos import vocos_from_state_dict
    from ns2vc_tpu_torch.ops.masking import sequence_mask

    r = np.random.default_rng(SEED)
    b, t, tp = 2, 64, 48
    inputs = {
        "c": 0.1 * r.standard_normal((b, t, 256)),
        "refer": r.standard_normal((b, tp, 100)),
        "x": r.standard_normal((b, t, 100)),
        "ts": np.array([500.0, 20.0]),
    }
    lengths, refer_lengths = torch.tensor([64, 45]), torch.tensor([48, 30])
    outs = {}
    for where in ("cuda", "cpu"):
        device = dev if where == "cuda" else torch.device("cpu")
        model = NaturalSpeech2(cfg)
        model.load_state_dict(sd)
        model.to(device).eval()
        vocos = vocos_from_state_dict(vsd, cfg.data.hop_length)
        vocos.load_state_dict(vsd)
        vocos.to(device).eval()
        c, refer, x, ts = (torch.tensor(inputs[k], dtype=torch.float32,
                                        device=device)
                           for k in ("c", "refer", "x", "ts"))
        with torch.no_grad():
            c_mask = sequence_mask(lengths.to(device), t)
            r_mask = sequence_mask(refer_lengths.to(device), tp)
            content, prompt = model.encode(c, refer, c_mask, r_mask)
            aug, kvs = model.precompute_conditioning(prompt)
            x0 = model.denoise(x, content, prompt, r_mask, ts, cross_kv=kvs,
                               aug_emb=aug)
            wav = vocos(x0)
        outs[where] = {"content": content, "prompt": prompt, "unet": x0,
                       "wav": wav}
    errs = {}
    for key in outs["cpu"]:
        a, b_ = outs["cuda"][key].cpu(), outs["cpu"][key]
        if not torch.isfinite(a).all():
            fail(f"full model: {key} not finite on the card")
        errs[key] = (a - b_).abs().max().item()
        say(f"full-width f32 {key:8s} shape={tuple(a.shape)} max_abs_err="
            f"{errs[key]:.3e} max_abs={b_.abs().max().item():.3e}")
    wav_scale = max(1.0, outs["cpu"]["wav"].abs().max().item())
    if not errs["unet"] <= UNET_ATOL:
        fail(f"full model: UNet error {errs['unet']} > {UNET_ATOL}")
    for key in ("content", "prompt"):
        if not errs[key] <= MODEL_ATOL:
            fail(f"full model: {key} error {errs[key]} > {MODEL_ATOL}")
    if not errs["wav"] <= MODEL_ATOL * wav_scale:
        fail(f"full model: waveform error {errs['wav']} > {MODEL_ATOL} x "
             f"{wav_scale}")
    say(f"full-width f32 card vs CPU: UNet {errs['unet']:.3e} <= "
        f"{UNET_ATOL}, waveform {errs['wav']:.3e} <= {MODEL_ATOL} x "
        f"max(1, max|wav|)={wav_scale:.3g}")


def device_breakdown(fn, wall_ms_unprofiled: float, label: str,
                     top: int = 8) -> dict:
    """One call of fn() under torch.profiler: device time by kernel, and
    the device's busy share of the same call timed without the profiler.
    Only device activity is recorded: with the host's ops as well, sorting
    the events took ~50 s per call. Returns {kernel name: (ms, count)}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace can miss the first kernels after it starts (once, a
        # B=1 eager call's first 14 K1 and 15 K2 launches): one small
        # kernel and a pause before the call
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(0.2)
        fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        by[e.key] = (us / 1e3, e.count)
    total = sum(ms for ms, _ in by.values())
    if total == 0:
        say(f"profile {label}: the profiler recorded no device time")
        return by
    say(f"profile {label}: {total:.1f} ms of kernel time in a call of "
        f"{wall_ms_unprofiled:.1f} ms unprofiled: device busy "
        f"{100 * total / wall_ms_unprofiled:.0f} % [{CARD}]")
    for name, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0])[:top]:
        say(f"  {ms:8.1f} ms {100 * ms / total:5.1f} % x{n:<6d} {name[:90]}")
    return by


def serving_profile(fn, wall_ms_unprofiled: float, label: str,
                    replay: bool = True) -> dict:
    """One serving call under torch.profiler: its kernel time, and the
    share of K1 (flash_fwd_wgmma / flash_fwd_tc / flash_fwd_f32_wgmma /
    flash_fwd_f32tc and its merge kernel; the two bf16 kernels and the f32
    wgmma kernel also apart), K2
    (affine_silu_conv_k3_wgmma / _f32tc and the f32 route's split reduce)
    and the GroupNorm statistics (group_norm_affine_kernel), each with its
    launches. For a replay the kernels the profile saw launched must be
    what the launch counters counted over the call (a replay adds what its
    capture counted): K1's and K2's main kernels and the statistics
    kernel. The trace can lose kernel records (the eager bodies' profiles
    have missed 6-120 of a call's ~5,000 counted launches), so a replay
    whose profile saw fewer is profiled again, at most three times in
    all; more kernels than counted fail at once. Through the eager body
    (`replay` False) every counted launch is a wrapper's own, so a
    difference there is the trace's and is only printed."""
    for attempt in range(1, 4):
        reset_launches()
        by = device_breakdown(fn, wall_ms_unprofiled, label)
        counted = route_counts()
        seen = {name: sum(n for kernel, (_, n) in by.items() if key in kernel)
                for name, key in KERNEL_NAMES}
        want = kernel_totals(counted)
        if seen == want or not replay:
            break
        if any(seen[k] > want[k] for k in want) or attempt == 3:
            fail(f"profile {label} (attempt {attempt}): kernels in the "
                 f"profile {seen}, launches counted {want}")
        say(f"profile {label}: attempt {attempt}: the trace holds "
            f"{seen} of the {want} kernels counted; profiling again")
    out = {"wall_ms": wall_ms_unprofiled,
           "kernel_ms": sum(ms for ms, _ in by.values()),
           "busy": sum(ms for ms, _ in by.values()) / wall_ms_unprofiled,
           "launches_counted": want}
    for key, names in (("k1", ("flash_fwd", "split_kv_merge")),
                       ("k1_wgmma", ("flash_fwd_wgmma",)),
                       ("k1_f32_wgmma", ("flash_fwd_f32_wgmma",)),
                       ("k1_tc", ("flash_fwd_tc_kernel",)),
                       ("k1_q1", ("flash_fwd_q1",)),
                       ("k2", ("affine_silu_conv_k3", "split_k_reduce")),
                       ("gn", ("group_norm_affine",))):
        hits = [(ms, n) for name, (ms, n) in by.items()
                if any(k in name for k in names)]
        out[f"{key}_ms"] = sum(ms for ms, _ in hits)
        out[f"{key}_launches"] = sum(n for _, n in hits)
    say(f"profile {label}: K1 {out['k1_ms']:.1f} ms ({out['k1_launches']} "
        f"kernels; wgmma {out['k1_wgmma_ms']:.1f} ms x"
        f"{out['k1_wgmma_launches']}, f32 wgmma "
        f"{out['k1_f32_wgmma_ms']:.1f} ms x{out['k1_f32_wgmma_launches']}, "
        f"mma.sync kernel {out['k1_tc_ms']:.1f}"
        f" ms x{out['k1_tc_launches']}, single-query kernel "
        f"{out['k1_q1_ms']:.2f} ms x{out['k1_q1_launches']}), K2 "
        f"{out['k2_ms']:.1f} ms "
        f"({out['k2_launches']}), "
        f"GroupNorm statistics (group_norm_affine_kernel) {out['gn_ms']:.1f} "
        f"ms ({out['gn_launches']}) of {out['kernel_ms']:.1f} ms kernel time; "
        f"the profile's K1 / K2 / statistics kernels {seen}, the launches "
        f"counted {want} [{CARD}]")
    return out


def k2_step_kernels(unet, dev) -> dict:
    """Device kernels of one B=16 bf16 UNet step's 45 resnet epilogues
    (`gn_silu_conv1d` at the serving bucket), counted by torch.profiler:
    with the statistics as torch ops (`group_norm_affine_plain`, the path
    before the statistics kernel) and through the statistics kernel."""
    from unittest import mock

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import ns2vc_tpu_torch.ops.fused_resnet as fr

    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    calls = []
    for _, t, c, co, film in resnet_cases(unet):
        x = torch.randn(B, t, c, generator=g, device=dev).bfloat16()
        w = (torch.randn(co, c, 3, generator=g, device=dev)
             / (3 * c) ** 0.5).bfloat16()
        p = [torch.randn(n, generator=g, device=dev).bfloat16()
             for n in (c, c, co)]
        f = (torch.randn(B, 2 * c, generator=g, device=dev).bfloat16()
             .chunk(2, dim=-1) if film else (None, None))
        calls.append((x, p[0], p[1], w, p[2], 8, 1e-5, *f))

    def count():
        for args in calls:      # warm: the packed weights and their maps
            fr.gn_silu_conv1d(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for args in calls:
                fr.gn_silu_conv1d(*args)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    with mock.patch.object(fr, "group_norm_affine", fr.group_norm_affine_plain):
        before = count()
    after = count()
    say(f"kernels per B={B} bf16 UNet step for its {len(calls)} resnet "
        f"epilogues: {before} with the GroupNorm statistics as torch ops "
        f"-> {after} with the statistics kernel ({before / len(calls):.1f} "
        f"-> {after / len(calls):.1f} per K2 call)")
    return {"torch_ops_statistics": before, "statistics_kernel": after}


def check_serving(cfg, sd, vsd, dev):
    import torch

    from ns2vc_tpu_torch.infer.svc import Svc

    svc = Svc(config=cfg, params=sd, vocos_params=vsd,
              compute_dtype="bfloat16", device=dev)
    r = np.random.default_rng(SEED + 2)
    clips = [(0.1 * r.standard_normal((T_CLIP, 256))).astype(np.float32)
             for _ in range(B)]
    refer = r.standard_normal((TP_REFER, 100)).astype(np.float32)
    hop = cfg.data.hop_length
    n_samples = T_CLIP * hop

    def run(output):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = svc.infer_batch(clips, refer, sampling_timesteps=STEPS,
                               order=2, output=output)
        torch.cuda.synchronize()
        return outs, (time.perf_counter() - t0) * 1e3

    # the first call at a key (f32 out): the eager warm-up, the capture and
    # one replay; its K1 calls recorded by geometry (the warm-up's and the
    # capture's: each stands for one launch) give the bf16 split (wgmma
    # kernel / tc_narrow) of its launches
    path = PathCalls()
    reset_launches()
    with contextlib.ExitStack() as stack:
        for patch in path.patches():
            stack.enter_context(patch)
        outs, warm_ms = run("float32")
    first = route_counts()
    if len(outs) != B or any(o.shape != (n_samples,) or o.dtype != np.float32
                             or not np.isfinite(o).all() for o in outs):
        fail("serving warm-up (float32): wrong count, shape, dtype or "
             "non-finite output")
    _, first_ms = run("pcm16")      # the pcm16 key's first call
    reset_launches()
    outs, ms = run("pcm16")         # a replay
    counts = bf16_counts = route_counts()
    if len(outs) != B or any(o.shape != (n_samples,) or o.dtype != np.int16
                             for o in outs):
        fail("serving (pcm16): wrong count, shape or dtype")
    n_levels = len(cfg.diffusion_encoder.block_out_channels)
    # bf16: everything on the tensor-core routes; the two pooling calls
    # (D = 100 and 4, one query) on the single-query kernel
    want = {"flash_attention_f32tc": 0, "flash_attention_f32tc_q1": 0,
            "flash_attention_tc": 14 + STEPS * 32,
            "flash_attention_f32tc_narrow": 0,
            "flash_attention_tc_narrow": 0, "flash_attention_tc_q1": 2,
            "affine_silu_conv1d_f32tc": 0, "affine_silu_conv1d_f32tc_elem": 0,
            "affine_silu_conv1d_tc": STEPS * 45,
            "affine_silu_conv1d_tc_elem": 0, "group_norm_affine": STEPS * 45}
    split = k1_split(path)
    if n_levels != 4 or route_totals(counts) != want or any(
            first[k] != n for k, n in split.items()) or any(
            first[k] != 2 * n for k, n in counts.items()):
        fail(f"launch counts {counts} (a replay), expected {want}; the first "
             f"call's {first} (warm-up and replay: twice a replay's), K1 "
             f"bf16 split {split}")
    keys = [k for k in svc._programs if k.batch == B]
    if sorted(svc._programs[k].replays for k in keys) != [1, 2]:
        fail(f"serving: programs {keys} replayed "
             f"{[svc._programs[k].replays for k in keys]} times, expected 1 "
             f"(float32) and 2 (pcm16)")
    audio_s = B * n_samples / cfg.data.sampling_rate
    say(f"serving B={B} T={T_CLIP} Tp={TP_REFER} steps={STEPS} bf16 pcm16: "
        f"{B} x int16 ({n_samples},) finite; first call at a key (warm-up, "
        f"capture, replay) {warm_ms:.1f} ms (float32 out), {first_ms:.1f} ms "
        f"(pcm16); replay {ms:.1f} ms = {audio_s / (ms / 1e3):.2f}x real "
        f"time; launches {counts} (first call {first}) [{CARD}]")
    single_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = svc.infer_from_features(clips[0], refer, sampling_timesteps=STEPS,
                                    order=2)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
        if w.shape != (n_samples,) or w.dtype != np.float32 \
                or not np.isfinite(w).all():
            fail("single request: wrong shape, dtype or non-finite output")
    say(f"single request B=1 T={T_CLIP} steps={STEPS} bf16: f32 "
        f"({n_samples},) finite; first (warm-up, capture, replay) "
        f"{single_ms[0]:.1f} ms, second (replay) {single_ms[1]:.1f} ms = "
        f"{n_samples / cfg.data.sampling_rate / (single_ms[1] / 1e3):.2f}x "
        f"real time [{CARD}]")
    walls = {"batch": ms, "single": single_ms[1]}
    # Svc's default dtype, f32: every K1 / K2 call on the 3xTF32 routes
    svc32 = Svc(config=cfg, params=sd, vocos_params=vsd, device=dev)
    run32 = lambda: svc32.infer_batch(clips, refer, sampling_timesteps=STEPS,
                                      order=2, output="pcm16")   # noqa: E731
    _, warm32 = wall_ms(run32)
    reset_launches()
    outs, walls["batch_f32"] = wall_ms(run32)
    counts = route_counts()
    want = {"flash_attention_f32tc": 14 + STEPS * 32,
            "flash_attention_f32tc_q1": 2,
            "flash_attention_tc": 0,
            "flash_attention_f32tc_narrow": 0,
            "flash_attention_tc_narrow": 0,
            "flash_attention_tc_q1": 0,
            "affine_silu_conv1d_f32tc": STEPS * 45,
            "affine_silu_conv1d_f32tc_elem": 0,
            "affine_silu_conv1d_tc": 0, "affine_silu_conv1d_tc_elem": 0,
            "group_norm_affine": STEPS * 45}
    if route_totals(counts) != want or len(outs) != B or any(
            o.shape != (n_samples,) or o.dtype != np.int16 for o in outs):
        fail(f"serving f32: launches {counts} (expected {want}), or wrong "
             f"count, shape or dtype")
    # each route's launches in the serving call of its dtype (the
    # statistics kernel's in the bf16 call, the main path's)
    served = {r: (counts if "f32tc" in r else bf16_counts)[r]
              for r in counts}
    served["group_norm_affine_f32"] = counts["group_norm_affine"]
    say(f"serving: kernels per K2 call (statistics + conv): "
        f"{(bf16_counts['group_norm_affine'] + bf16_counts['affine_silu_conv1d_tc']) / (STEPS * 45):g} "
        f"in bf16, {(counts['group_norm_affine'] + counts['affine_silu_conv1d_f32tc']) / (STEPS * 45):g} "
        f"in f32")
    say(f"serving B={B} T={T_CLIP} Tp={TP_REFER} steps={STEPS} f32 (Svc's "
        f"default dtype) pcm16: first call {warm32:.1f} ms, replay "
        f"{walls['batch_f32']:.1f} ms = "
        f"{audio_s / (walls['batch_f32'] / 1e3):.2f}x real time; launches "
        f"{counts} [{CARD}]")
    return svc, svc32, clips, refer, walls, served


# -- the compiled serving programs -------------------------------------------

DDPM_TIMESTEPS = 25   # DDPM's model copy: 25 diffusion steps (betas < 1)
REDUCED_STEPS = 10    # DDIM with eta > 0
DDIM_ETA = 0.5


def eager_body(svc):
    """Svc's calls through its eager body instead of its programs."""
    from unittest import mock

    return mock.patch.object(svc, "_run", svc._run_eager)


def same_audio(a: list, b: list) -> float | None:
    """None when two calls' waveforms are equal bit for bit, else their
    largest difference."""
    if len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                for x, y in zip(a, b)):
        return None
    return max(float(np.abs(x.astype(np.float64) - y).max())
               for x, y in zip(a, b))


def program_lines(name, svc) -> list:
    """Per program of a Svc: its key, capture ms, graph nodes, replays."""
    out = []
    for k, p in svc._programs.items():
        out.append({"svc": name, "method": k.method, "steps": k.steps,
                    "eta": k.eta, "batch": k.batch, "t_pad": k.t_pad,
                    "tp_pad": k.tp_pad, "output": k.output,
                    "dtype": str(k.dtype)[6:], "use_f0": k.use_f0,
                    "tf32": [k.tf32_matmul, k.tf32_cudnn],
                    "capture_ms": p.capture_ms, "nodes": p.nodes,
                    "replays": p.replays})
        say(f"  program {name} {k.method} steps={k.steps} eta={k.eta} "
            f"B={k.batch} T={k.t_pad} Tp={k.tp_pad} {k.output} "
            f"{str(k.dtype)[6:]} tf32={k.tf32_matmul}/{k.tf32_cudnn}: "
            f"capture {p.capture_ms:.1f} ms, {p.nodes} graph nodes, "
            f"{p.replays} replays")
    return out


KERNEL_NAMES = (("k1", "flash_fwd"), ("k2", "affine_silu_conv_k3"),
                ("gn", "group_norm_affine"))


def kernel_totals(counted: dict) -> dict:
    """The K1 / K2 / statistics kernel launches in a route_counts() dict."""
    return {"k1": counted["flash_attention_f32tc"]
            + counted["flash_attention_tc"],
            "k2": counted["affine_silu_conv1d_f32tc"]
            + counted["affine_silu_conv1d_tc"],
            "gn": counted["group_norm_affine"]}


# CUgraphNodeType
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


def graph_census(graph) -> tuple[Counter, Counter]:
    """(kernel nodes by function name, nodes by type) of a CUDA graph kept
    after instantiation (keep_graph=True), read through libcuda (node
    types, kernel node parameters, function names; child graphs walked):
    what each replay runs, independent of any tracer."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    vp = ctypes.c_void_p

    def check(err, what):
        if err != 0:
            fail(f"graph nodes: {what} returned CUresult {err}")

    names, kernels, types = {}, Counter(), Counter()
    params = (ctypes.c_uint8 * 128)()   # CUDA_KERNEL_NODE_PARAMS_v2: 72 B
    kind, name, child = ctypes.c_int(), ctypes.c_char_p(), vp()

    def walk(g):
        n = ctypes.c_size_t(0)
        check(cu.cuGraphGetNodes(vp(g), None, ctypes.byref(n)),
              "cuGraphGetNodes")
        nodes = (vp * n.value)()
        check(cu.cuGraphGetNodes(vp(g), nodes, ctypes.byref(n)),
              "cuGraphGetNodes")
        for node in nodes:
            check(cu.cuGraphNodeGetType(vp(node), ctypes.byref(kind)),
                  "cuGraphNodeGetType")
            types[NODE_TYPES[kind.value] if kind.value < len(NODE_TYPES)
                  else str(kind.value)] += 1
            if kind.value == 4:     # CU_GRAPH_NODE_TYPE_GRAPH
                check(cu.cuGraphChildGraphNodeGetGraph(
                    vp(node), ctypes.byref(child)),
                    "cuGraphChildGraphNodeGetGraph")
                walk(child.value)
                continue
            if kind.value != 0:     # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            check(cu.cuGraphKernelNodeGetParams_v2(vp(node), params),
                  "cuGraphKernelNodeGetParams_v2")
            func = vp.from_buffer(params, 0).value     # CUfunction
            kern = vp.from_buffer(params, 56).value    # CUkernel
            handle = func or kern
            if handle not in names:
                get = cu.cuFuncGetName if func else cu.cuKernelGetName
                check(get(ctypes.byref(name), vp(handle)),
                      "cuFuncGetName" if func else "cuKernelGetName")
                names[handle] = name.value.decode()
            kernels[names[handle]] += 1
    walk(graph.raw_cuda_graph())
    return kernels, types


def graph_kernels(graph) -> dict:
    """The K1 / K2 / statistics kernel nodes of a CUDA graph (see
    `graph_census`): the kernels each replay launches."""
    kernels, _ = graph_census(graph)
    return {k: sum(n for name, n in kernels.items() if key in name)
            for k, key in KERNEL_NAMES}


def check_compiled_serving(cfg, sd, vsd, svc, svc32, clips, refer, dev):
    """The serving programs against the eager body (`Svc._run_eager`) at
    the same seed, bit for bit: B=16 bf16 pcm16, B=1 bf16 f32 out and B=16
    f32 pcm16 (Svc's default dtype), each timed in turns (eager, graph,
    graph, eager) with its launches counted through the eager body and
    through a replay, which must agree; DDIM with eta > 0 (10 steps) and
    DDPM (a copy of the model with 25 diffusion steps) at B=16, whose
    pre-drawn per-step noise must keep the seed's result; two dispatches
    of one key in flight, each read back as its own batch's audio; and
    each program's capture time, graph nodes and replays."""
    import dataclasses

    import torch

    from ns2vc_tpu_torch.infer.svc import Svc

    hop = cfg.data.hop_length
    res = {"cases": {}}
    for name, s, cl, out in (("b16_bf16_pcm16", svc, clips, "pcm16"),
                             ("b1_bf16_f32out", svc, clips[:1], "float32"),
                             ("b16_f32_pcm16", svc32, clips, "pcm16")):
        audio, walls, launches = [], defaultdict(list), {}
        before = {k: p.replays for k, p in s._programs.items()}
        for mode in ("eager", "graph", "graph", "eager"):
            ctx = eager_body(s) if mode == "eager" else \
                contextlib.nullcontext()
            reset_launches()
            with ctx:
                o, ms = wall_ms(lambda: s.infer_batch(
                    cl, refer, sampling_timesteps=STEPS, order=2,
                    output=out))
            launches.setdefault(mode, route_counts())
            audio.append(o)
            walls[mode].append(ms)
        diffs = [same_audio(audio[0], a) for a in audio[1:]]
        if any(d is not None for d in diffs):
            fail(f"compiled serving {name}: graph and eager outputs differ "
                 f"(largest difference per call after the first eager: "
                 f"{diffs})")
        if launches["eager"] != launches["graph"] or not any(
                launches["graph"].values()):
            fail(f"compiled serving {name}: launches through the eager body "
                 f"{launches['eager']}, through a replay "
                 f"{launches['graph']}")
        # the program's graph holds the launches its replays add
        progs = [p for k, p in s._programs.items()
                 if p.replays > before.get(k, 0)]
        nodes = graph_kernels(progs[0].graph) if len(progs) == 1 else None
        if nodes != kernel_totals(launches["graph"]):
            fail(f"compiled serving {name}: programs replayed "
                 f"{[p.key for p in progs]}, K1 / K2 / statistics kernel "
                 f"nodes in its graph {nodes}, launches counted per replay "
                 f"{kernel_totals(launches['graph'])}")
        e, g = (float(np.mean(walls[m])) for m in ("eager", "graph"))
        audio_s = len(cl) * cl[0].shape[0] * hop / cfg.data.sampling_rate
        res["cases"][name] = {"eager_ms": walls["eager"],
                              "graph_ms": walls["graph"],
                              "launches": launches["graph"],
                              "graph_kernel_nodes": nodes}
        say(f"compiled serving {name} (B={len(cl)} T={T_CLIP} steps={STEPS}):"
            f" graph == eager bit for bit ({len(cl)} x "
            f"{audio[0][0].dtype}); wall ms in turns eager "
            f"{walls['eager'][0]:.1f}, graph {walls['graph'][0]:.1f}, graph "
            f"{walls['graph'][1]:.1f}, eager {walls['eager'][1]:.1f}: "
            f"{e / g:.2f}x, {audio_s / (g / 1e3):.2f}x real time; launches "
            f"per call {launches['graph']}; K1 / K2 / statistics kernel "
            f"nodes in the graph {nodes} [{CARD}]")

    # the samplers that draw noise: pre-drawn, the seed's result
    cfg_ddpm = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, timesteps=DDPM_TIMESTEPS))
    svc_ddpm = Svc(config=cfg_ddpm, params=sd, vocos_params=vsd,
                   compute_dtype="bfloat16", device=dev)
    for name, s, kw in (
            ("ddim_eta", svc, dict(sample_method="ddim", eta=DDIM_ETA,
                                   sampling_timesteps=REDUCED_STEPS)),
            ("ddpm", svc_ddpm, dict(sample_method="ddpm"))):
        runs = {}
        for label, seed, eager in (("graph", 0, False), ("eager", 0, True),
                                   ("graph_again", 0, False),
                                   ("graph_seed1", 1, False),
                                   ("eager_seed1", 1, True)):
            with (eager_body(s) if eager else contextlib.nullcontext()):
                runs[label], ms = wall_ms(lambda: s.infer_batch(
                    clips, refer, seed=seed, output="float32", **kw))
            runs[f"{label}_ms"] = ms
        diffs = {k: same_audio(runs["graph"], runs[k])
                 for k in ("eager", "graph_again")}
        diffs["seed1"] = same_audio(runs["graph_seed1"], runs["eager_seed1"])
        if any(d is not None for d in diffs.values()) or same_audio(
                runs["graph"], runs["graph_seed1"]) is None:
            fail(f"compiled serving {name}: graph vs eager at the same seed "
                 f"{diffs} (None: bit for bit), or seeds 0 and 1 agree")
        n_draws = len(next(
            p for k, p in s._programs.items()
            if k.method == kw["sample_method"] and k.eta == kw.get(
                "eta", 0.0) and k.steps == kw.get("sampling_timesteps", 30)
        ).static["draws"])
        res["cases"][name] = {k: runs[k] for k in runs if k.endswith("_ms")}
        res["cases"][name]["noise_draws"] = n_draws
        say(f"compiled serving {name} B={B} ({kw}): graph == eager bit for "
            f"bit at seeds 0 and 1 with {n_draws} pre-drawn noise tensors, "
            f"seeds 0 and 1 differ; first call {runs['graph_ms']:.1f} ms, "
            f"eager {runs['eager_ms']:.1f}, replay "
            f"{runs['graph_again_ms']:.1f} [{CARD}]")

    # two dispatches of one key in flight, each read back as its own audio
    r = np.random.default_rng(SEED + 12)
    clips_b = [(0.1 * r.standard_normal((T_CLIP, 256))).astype(np.float32)
               for _ in range(B)]
    kw = dict(sampling_timesteps=STEPS, order=2, output="pcm16")
    want_a = svc.infer_batch(clips, refer, seed=0, **kw)
    want_b = svc.infer_batch(clips_b, refer, seed=1, **kw)
    torch.cuda.synchronize()
    fa = svc.infer_batch_async(clips, refer, seed=0, **kw)
    fb = svc.infer_batch_async(clips_b, refer, seed=1, **kw)
    a_pending = fa.done is not None and not fa.done.query()
    got_a, got_b = fa(), fb()
    if same_audio(got_a, want_a) is not None or same_audio(
            got_b, want_b) is not None or same_audio(got_a, got_b) is None:
        fail("compiled serving: two dispatches of one key in flight did not "
             "each read back its own batch's audio")
    say(f"compiled serving: two B={B} dispatches of one key in flight (batch "
        f"1 still running when batch 2 was enqueued: {a_pending}): each read "
        f"back its own audio, bit for bit [{CARD}]")
    res["in_flight"] = {"first_pending_at_second_dispatch": a_pending}
    say("serving programs (capture: host ms of capture and instantiation):")
    res["programs"] = (program_lines("bf16", svc) + program_lines("f32", svc32)
                       + program_lines("ddpm", svc_ddpm))
    res["memory"] = {"bf16": svc._program_memory(),
                     "f32": svc32._program_memory()}
    del svc_ddpm
    torch.cuda.empty_cache()
    return res


# -- slice 2: front end, samplers, overlap, MicroBatcher, wav in -> wav out ---

def tone(n: int, sr: int, seed: int, f: float = 220.0) -> np.ndarray:
    """A voiced-like test signal: a harmonic tone with vibrato and noise."""
    r = np.random.default_rng(seed)
    t = np.arange(n) / sr
    ph = 2 * np.pi * f * t + 3.0 * np.sin(2 * np.pi * 5 * t)
    x = 0.3 * np.sin(ph) + 0.15 * np.sin(2 * ph) + 0.05 * np.sin(3 * ph)
    return (x + 0.01 * r.standard_normal(n)).astype(np.float32)


def front_end_weights():
    """Seeded full-width ContentVec and CREPE 'full' state dicts."""
    import torch

    from ns2vc_tpu_torch.convert import (
        init_contentvec_params, init_crepe_params,
    )

    gen = torch.Generator().manual_seed(SEED + 4)
    return init_contentvec_params(gen), init_crepe_params(gen, "full")


def check_front_end(dev, cv_sd, crepe_sd):
    """f32, TF32 off: resampling 44.1 k -> 24 k / 16 k and log-mel of a 17 s
    signal, full-width ContentVec on 4 s and CREPE full on 2 s, card vs
    CPU."""
    import torch
    import torch.nn.functional as F

    from ns2vc_tpu_torch.audio.mel import log_mel_spectrogram
    from ns2vc_tpu_torch.audio.resample import resample
    from ns2vc_tpu_torch.features.contentvec import ContentVec
    from ns2vc_tpu_torch.features.crepe import WINDOW, Crepe

    cpu = torch.device("cpu")
    x44 = torch.from_numpy(tone(17 * 44100, 44100, SEED + 3))
    errs = {}

    def compare(name, fn, tol, mask_fn=None):
        got, ms = wall_ms(lambda: fn(dev))
        want = fn(cpu)
        got = got.cpu()
        if not torch.isfinite(got).all():
            fail(f"front end: {name} not finite on the card")
        diff = (got - want).abs()
        if mask_fn is not None:
            diff = diff[mask_fn(want)]
        errs[name] = diff.max().item()
        say(f"front end f32 {name:22s} shape={tuple(got.shape)} "
            f"max_abs_err={errs[name]:.3e} (tol {tol:g}) card_ms={ms:.2f} "
            f"[{CARD}]")
        if not errs[name] <= tol:
            fail(f"front end: {name} error {errs[name]} > {tol}")
        return want

    with no_tf32(), torch.no_grad():
        compare("resample 44.1k->24k",
                lambda d: resample(x44.to(d), 44100, 24000), RESAMPLE_ATOL)
        compare("resample 44.1k->16k",
                lambda d: resample(x44.to(d), 44100, 16000), RESAMPLE_ATOL)
        x24 = resample(x44, 44100, 24000)
        compare("log-mel 24k (above clip)",
                lambda d: log_mel_spectrogram(x24.to(d)), MEL_ATOL,
                lambda w: w > float(np.log(1e-7)) + 1e-3)

        models = {}
        for d in (dev, cpu):
            cv = ContentVec()
            cv.load_state_dict(cv_sd)
            cr = Crepe("full")
            cr.load_state_dict(crepe_sd)
            models[d.type] = (cv.to(d).eval(), cr.to(d).eval())
        wav16 = resample(x44[: 4 * 44100], 44100, 16000)[None]
        reset_launches()
        compare("ContentVec 768x12, 4 s",
                lambda d: models[d.type][0](wav16.to(d)), CONTENTVEC_ATOL)
        n = route_counts()["flash_attention_f32tc"]
        if n != 12:
            fail(f"ContentVec launched K1's f32 route {n} times, expected 12 "
                 f"(one per layer)")
        x16 = F.pad(resample(x44[: 2 * 44100], 44100, 16000),
                    (WINDOW // 2, WINDOW // 2))
        frames = x16.unfold(0, WINDOW, 171)   # hop 256 at 24 kHz -> 16 kHz
        frames = (frames - frames.mean(1, keepdim=True)) / torch.clamp(
            frames.std(1, keepdim=True, correction=0), min=1e-10)
        compare(f"CREPE full, {frames.shape[0]} frames",
                lambda d: models[d.type][1](frames.to(d)), CREPE_ATOL)


def check_samplers(svc, clips, refer, hop, sr):
    """ddim (50 steps), dpmsolver (order 2, 50 steps) and unipc (50 steps)
    through Svc.infer_batch at B=16 x 400 frames, bf16, pcm16: the first
    call at each key (unipc's is warm from check_serving) and a replay."""
    audio_s = len(clips) * clips[0].shape[0] * hop / sr
    for method in ("ddim", "dpmsolver", "unipc"):
        ms = []
        for _ in range(2):
            outs, t = wall_ms(lambda: svc.infer_batch(
                clips, refer, sample_method=method, sampling_timesteps=STEPS,
                order=2, output="pcm16"))
            ms.append(t)
            if any(o.shape != (clips[0].shape[0] * hop,)
                   or o.dtype != np.int16 for o in outs):
                fail(f"sampler {method}: wrong shape or dtype")
        say(f"sampler {method:9s} B={len(clips)} T={clips[0].shape[0]} "
            f"steps={STEPS} bf16 pcm16: {ms[0]:.1f} ms, then {ms[1]:.1f} ms "
            f"= {audio_s / (ms[1] / 1e3):.2f}x real time [{CARD}]")


def check_overlap(svc, refer):
    """Batch 1's finish() must return while batch 2, dispatched after it,
    is still running: the readback waits on its own event. Both geometries
    run once first (a geometry's first call synchronises in the libraries'
    set-up), and batch 2's device work ends in ~0.5 s of spin, so the check
    does not hang on how far the host runs ahead of the card."""
    import torch

    r = np.random.default_rng(SEED + 5)
    small = [(0.1 * r.standard_normal((100, 256))).astype(np.float32)
             for _ in range(4)]
    big = [(0.1 * r.standard_normal((1600, 256))).astype(np.float32)
           for _ in range(16)]
    svc.infer_batch(small, refer, sampling_timesteps=5)
    svc.infer_batch(big, refer, sampling_timesteps=30, output="pcm16")
    run = svc._run

    def run_then_spin(*args, **kwargs):
        wav = run(*args, **kwargs)
        torch.cuda._sleep(int(1e9))
        return wav
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f1 = svc.infer_batch_async(small, refer, sampling_timesteps=5)
    svc._run = run_then_spin
    try:
        f2 = svc.infer_batch_async(big, refer, sampling_timesteps=30,
                                   output="pcm16")
    finally:
        del svc._run
    t_dispatched = time.perf_counter()
    outs = f1()
    t_f1 = time.perf_counter()
    pending = not f2.done.query()
    outs2 = f2()
    t_f2 = time.perf_counter()
    if not pending:
        fail("overlap: batch 1's finish() returned only after batch 2's "
             "device work had finished")
    if len(outs) != 4 or len(outs2) != 16 or outs2[0].dtype != np.int16:
        fail("overlap: wrong outputs")
    say(f"readback overlap: both dispatched at {1e3 * (t_dispatched - t0):.0f}"
        f" ms; batch 1 (4x100, 5 steps) read back at "
        f"{1e3 * (t_f1 - t0):.0f} ms with batch 2 (16x1600, 30 steps, then "
        f"a spin) still running; batch 2 read back at "
        f"{1e3 * (t_f2 - t0):.0f} ms [{CARD}]")


MB_STEPS = 10   # the MicroBatcher's sampler steps: each of its 8 keys
                # pays a warm-up and a capture


def check_microbatcher(svc, refer, hop):
    """32 requests of 150-600 frames from 4 threads through one
    MicroBatcher (max_batch 16, max_inflight 2, pcm16, 10 UniPC steps):
    each dispatch one replay, and the memory the program cache holds after
    it."""
    import torch

    from ns2vc_tpu_torch.infer.serve import MicroBatcher

    r = np.random.default_rng(SEED + 6)
    lens = r.integers(150, 601, size=32)
    clips = [(0.1 * r.standard_normal((int(n), 256))).astype(np.float32)
             for n in lens]
    futs = [None] * 32
    before = {k: p.replays for k, p in svc._programs.items()}
    t0 = time.perf_counter()
    with MicroBatcher(svc, refer, max_batch=16, max_inflight=2,
                      sampling_timesteps=MB_STEPS, output="pcm16") as mb:
        def client(k):
            for i in range(k, 32, 4):
                futs[i] = mb.submit(clips[i])
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        outs = [f.result(timeout=600) for f in futs]
        mix = list(mb.dispatch_log)
    wall = (time.perf_counter() - t0) * 1e3
    for n, o in zip(lens, outs):
        if o.shape != (int(n) * hop,) or o.dtype != np.int16:
            fail(f"MicroBatcher: a {n}-frame request came back "
                 f"{o.shape} {o.dtype}")
    if svc._refer_cache:
        fail(f"MicroBatcher: {len(svc._refer_cache)} refer cache entries "
             f"left after close()")
    audio_s = float(lens.sum()) * hop / 24000
    replays = {f"{k.batch}x{k.t_pad}": p.replays - before.get(k, 0)
               for k, p in svc._programs.items()
               if p.replays > before.get(k, 0)}
    if sum(replays.values()) != len(mix):
        fail(f"MicroBatcher: {len(mix)} dispatches, program replays "
             f"{replays}")
    mem = svc._program_memory()
    say(f"MicroBatcher 32 requests (150-600 frames, 4 threads) steps="
        f"{MB_STEPS} pcm16: batches (real, dispatched) {mix}; wall "
        f"{wall:.0f} ms = {audio_s / (wall / 1e3):.2f}x real time; refer "
        f"cache empty after close; replays per program (B x T_pad) "
        f"{replays} [{CARD}]")
    say(f"program cache after the MicroBatcher: {mem['programs']} programs, "
        f"static buffers {mem['static_bytes'] / 2**20:.1f} MiB, shared graph "
        f"pool {mem['pool_bytes'] / 2**20:.1f} MiB; card memory allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, reserved "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB [{CARD}]")
    return {"dispatches": mix, "replays": replays, "wall_ms": wall, **mem}


class Stages:
    """Exclusive wall time per stage: each wrapped call synchronises the
    card before and after, and a nested stage's time is taken out of its
    parent's."""

    def __init__(self):
        self.ms = defaultdict(float)
        self._stack = []

    def wrap(self, name, fn):
        import torch

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                dt = (time.perf_counter() - t0) * 1e3
                self.ms[name] += dt - self._stack.pop()
                if self._stack:
                    self._stack[-1] += dt
        return timed


def write_checkpoints(tmp, sd, vsd, cv_sd, crepe_sd) -> dict:
    """The seeded weights in the files the CLI reads: a port state dict,
    and the public fairseq contentvec (with head metadata), Vocos and
    torchcrepe layouts, written by the port's inverses of its loaders."""
    import torch

    from ns2vc_tpu_torch.features.contentvec import contentvec_to_fairseq
    from ns2vc_tpu_torch.features.crepe import crepe_to_torchcrepe
    from ns2vc_tpu_torch.models.vocos import vocos_to_public

    paths = {k: os.path.join(tmp, f) for k, f in (
        ("model", "model.pt"), ("cv", "contentvec.pt"),
        ("vocos", "vocos.bin"), ("crepe", "full.pth"))}
    torch.save(sd, paths["model"])
    torch.save({"model": contentvec_to_fairseq(cv_sd),
                "cfg": {"model": {"encoder_attention_heads": 12}}},
               paths["cv"])
    torch.save(vocos_to_public(vsd), paths["vocos"])
    torch.save(crepe_to_torchcrepe(crepe_sd), paths["crepe"])
    return paths


def check_cli(cfg, sd, vsd, cv_sd, crepe_sd):
    """wav in -> wav out at full width through the port CLI's main(): bf16
    unipc (counted, with every K1 / K2 call's geometry recorded, then timed
    by stage), bf16 -fmp (CREPE F0, timed), and f32 with TF32 off through
    the kernels against the same run through their plain versions."""
    from unittest import mock

    import ns2vc_tpu_torch.infer.svc as svc_mod
    import ns2vc_tpu_torch.ops.attention as attention
    import ns2vc_tpu_torch.ops.fused_resnet as fused_resnet
    from ns2vc_tpu_torch.audio.host import Slicer, read_wav, write_wav
    from ns2vc_tpu_torch.features.contentvec import ContentVec
    from ns2vc_tpu_torch.infer.cli import main as cli_main
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention_plain
    from ns2vc_tpu_torch.ops.fused_resnet import affine_silu_conv1d_plain

    sr = 44100
    src = np.concatenate([tone(int(6.0 * sr), sr, SEED + 7, 200.0),
                          np.zeros(sr, np.float32),
                          tone(int(6.5 * sr), sr, SEED + 8, 240.0),
                          np.zeros(sr, np.float32),
                          tone(int(5.5 * sr), sr, SEED + 9, 180.0)])
    want_len = -(-len(src) * cfg.data.sampling_rate // sr)
    hop = cfg.data.hop_length
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_checkpoints(tmp, sd, vsd, cv_sd, crepe_sd)
        raw = os.path.join(tmp, "raw")
        os.makedirs(raw)
        write_wav(os.path.join(raw, "src.wav"), src, sr)
        write_wav(os.path.join(raw, "ref.wav"), tone(3 * sr, sr, SEED + 10,
                                                     150.0), sr)
        argv = ["-m", paths["model"], "-n", "src.wav", "-r", "ref.wav",
                "--contentvec_ckpt", paths["cv"], "--vocos_ckpt",
                paths["vocos"], "--crepe_ckpt", paths["crepe"],
                "--raw_dir", raw, "--out_dir", os.path.join(tmp, "out"),
                "--compute_dtype", "bfloat16", "--sampling_timesteps",
                str(CLI_STEPS)]
        out_path = os.path.join(tmp, "out", "src_0key_ref.wav")
        slice_inference = svc_mod.Svc.slice_inference

        def run(extra, stages=None, patches=()):
            """One CLI run: (launch counts, calls of ContentVec and of the
            device batch, wall ms, the converted audio before writing)."""
            calls, audio = defaultdict(int), []

            def counted(name, fn):
                def f(*a, **k):
                    calls[name] += 1
                    return fn(*a, **k)
                return f

            def kept(*a, **k):
                audio.append(slice_inference(*a, **k))
                return audio[-1]
            patches = [
                *patches,
                mock.patch.object(ContentVec, "forward", counted(
                    "contentvec", ContentVec.forward)),
                mock.patch.object(svc_mod.Svc, "_run", counted(
                    "batches", svc_mod.Svc._run)),
                mock.patch.object(svc_mod.Svc, "_capture", counted(
                    "programs", svc_mod.Svc._capture)),
                mock.patch.object(svc_mod.Svc, "slice_inference", kept)]
            if stages is not None:
                for obj, attr, name in (
                        (svc_mod.Svc, "__init__", "load checkpoints"),
                        (Slicer, "slice", "slicer"),
                        (svc_mod, "resample", "resample"),
                        (svc_mod.Svc, "compute_f0", "F0"),
                        (ContentVec, "forward", "ContentVec"),
                        (svc_mod.Svc, "compute_refer_mel", "refer mel"),
                        # the serving program: the sampler and Vocos, with
                        # each batch's warm-up and capture (a fresh Svc)
                        (svc_mod.Svc, "_run", "device program")):
                    patches.append(mock.patch.object(
                        obj, attr, stages.wrap(name, getattr(obj, attr))))
            reset_launches()
            with contextlib.ExitStack() as stack:
                for p in patches:
                    stack.enter_context(p)
                _, ms = wall_ms(lambda: cli_main(argv + extra))
            counts = route_counts()
            wav, out_sr = read_wav(out_path)
            if out_sr != cfg.data.sampling_rate or not np.isfinite(
                    wav).all() or abs(len(wav) - want_len) > hop:
                fail(f"CLI {extra}: output {len(wav)} samples at {out_sr} "
                     f"Hz, expected {want_len} +- {hop} at "
                     f"{cfg.data.sampling_rate}, finite")
            os.remove(out_path)
            return counts, dict(calls), ms, audio[0]

        path_calls = PathCalls()
        counts, calls, ms, _ = run([], patches=path_calls.patches())
        # ContentVec runs in f32 (the 3xTF32 route), the UNet, encoders and
        # pooling in bf16 (the bf16 tensor-core routes). Each device batch
        # is one replay, and each program's first call (a fresh Svc: each
        # batch's) also runs its body eagerly once, the warm-up
        runs = calls["batches"] + calls.get("programs", 0)
        want = {"flash_attention_f32tc": 12 * calls["contentvec"],
                "flash_attention_f32tc_q1": 0,
                "flash_attention_tc": runs * (14 + 32 * CLI_STEPS),
                "flash_attention_f32tc_narrow": 0,
                "flash_attention_tc_narrow": 0,
                "flash_attention_tc_q1": 2 * runs,
                "affine_silu_conv1d_f32tc": 0,
                "affine_silu_conv1d_f32tc_elem": 0,
                "affine_silu_conv1d_tc": runs * 45 * CLI_STEPS,
                "affine_silu_conv1d_tc_elem": 0,
                "group_norm_affine": runs * 45 * CLI_STEPS}
        split = k1_split(path_calls)
        if route_totals(counts) != want or calls["contentvec"] < 3 or any(
                counts[k] != n for k, n in split.items()):
            fail(f"CLI launch counts {counts} for {calls}, expected {want}, "
                 f"K1 bf16 split {split}")
        recorded = (sum(path_calls.k1.values()), sum(path_calls.k2.values()))
        if recorded != (counts["flash_attention_f32tc"]
                        + counts["flash_attention_tc"],
                        counts["affine_silu_conv1d_tc"]):
            fail(f"CLI: {recorded} wrapper calls recorded, {counts} "
                 f"launches counted")
        say(f"wav in -> wav out, CLI unipc {CLI_STEPS} steps bf16: 20.0 s "
            f"source at 44.1 kHz -> {want_len} samples at 24 kHz, finite; "
            f"{ms:.0f} ms = {len(src) / sr / (ms / 1e3):.2f}x real time; "
            f"{calls['contentvec']} ContentVec calls, {calls['batches']} "
            f"device batches, {calls.get('programs', 0)} programs captured; "
            f"launches {counts}; K1 geometries "
            f"{len(path_calls.k1)}, K2 geometries {len(path_calls.k2)} "
            f"[{CARD}]")
        for name, extra in (("unipc", []), ("-fmp (CREPE)", ["-fmp"])):
            stages = Stages()
            _, _, ms, _ = run(extra, stages)
            rest = ms - sum(stages.ms.values())
            parts = ", ".join(f"{k} {v:.0f}" for k, v in stages.ms.items())
            say(f"wav in -> wav out, CLI {name}, ms per stage (synchronised): "
                f"{parts}, assembly and the rest {rest:.0f}; total {ms:.0f} "
                f"[{CARD}]")

        # f32, TF32 off: the same conversion through the kernels and
        # through their plain versions
        f32 = ["--compute_dtype", "float32"]
        with no_tf32():
            k_counts, _, k_ms, k_wav = run(f32)
            p_counts, _, p_ms, p_wav = run(f32, patches=[
                mock.patch.object(attention, "flash_attention",
                                  flash_attention_plain),
                mock.patch.object(fused_resnet, "affine_silu_conv1d",
                                  affine_silu_conv1d_plain),
                mock.patch.object(fused_resnet, "group_norm_affine",
                                  fused_resnet.group_norm_affine_plain)])
        f32_want = {"flash_attention_f32tc": counts["flash_attention_f32tc"]
                    + counts["flash_attention_tc"],
                    "flash_attention_f32tc_q1": counts["flash_attention_tc_q1"],
                    "flash_attention_tc": 0,
                    "flash_attention_f32tc_narrow": 0,
                    "flash_attention_tc_narrow": 0,
                    "flash_attention_tc_q1": 0,
                    "affine_silu_conv1d_f32tc": counts["affine_silu_conv1d_tc"],
                    "affine_silu_conv1d_f32tc_elem": 0,
                    "affine_silu_conv1d_tc": 0, "affine_silu_conv1d_tc_elem": 0,
                    "group_norm_affine": counts["group_norm_affine"]}
        if route_totals(k_counts) != f32_want or max(p_counts.values()) != 0:
            fail(f"CLI f32: launches {k_counts} through the kernels "
                 f"(expected {f32_want}), {p_counts} through the plain "
                 f"versions")
        scale = max(1.0, float(np.abs(p_wav).max()))
        err = float(np.abs(k_wav - p_wav).max()) if k_wav.shape == \
            p_wav.shape else float("inf")
        say(f"wav in -> wav out, CLI unipc {CLI_STEPS} steps f32 (TF32 off), "
            f"kernels vs plain versions: {k_wav.shape[0]} samples, "
            f"max_abs_err={err:.3e} (tol {CLI_WAV_ATOL:g} x max(1, "
            f"max|wav|)={scale:.3g}); {k_ms:.0f} ms vs {p_ms:.0f} ms "
            f"[{CARD}]")
        if not err <= CLI_WAV_ATOL * scale:
            fail(f"CLI f32: kernels vs plain versions differ by {err} > "
                 f"{CLI_WAV_ATOL} x {scale}")
    return counts, k_counts, path_calls


# -- slice 4: training -------------------------------------------------------

TRAIN_B, TRAIN_T = 32, 272    # the training batch: 32 x 272 content / refer
TRAIN_WARMUP, TRAIN_TIMED = 3, 12
LOSS_STEPS = 30               # steps on one fixed batch, fixed t and noise
# f32, TF32 off, card vs CPU: each tensor's gradient within GRAD_RTOL of
# max(1e-3, max|g_cpu|), the bound the CPU tests hold the port's gradients
# to against jax.grad
GRAD_RTOL = 1e-4
# the F0 prenet's LayerNorm over one channel normalises x - mean(x) = 0:
# the gradient of its scale is zero in exact arithmetic
PRENET_LN_SCALE = "pre_model.f0_predictor.f0_prenet.LayerNorm_0.weight"
GRAD_COSINE = 0.99            # bf16 kernels vs f32 plain, per tensor
BF16_COSINE_GAP = 5e-3        # the kernels' allowance below plain bf16
K1_GRAD_BF16 = 3e-2           # bf16 backward vs plain autograd, of
K2_GRAD_BF16 = 3e-2           # max(1, max|grad|)
TRAIN_WAVS = 12


def k1_backward_bound(q, k, bias):
    """dQ, dK, dV of one attention: five products of B*H*Tq*Tk*D (S
    recomputed, dV, dP, dQ, dK); q, k, v, dO read, dq, dk, dv written."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    nbytes = q.element_size() * (3 * b * h * tq * d + 4 * b * h * tk * d)
    return bound(10.0 * b * h * tq * tk * d,
                 nbytes + (0 if bias is None else 4 * b * tk), q.dtype)


def gn_backward_bound(bsz, t, c, dtype):
    """The statistics' backward: x read and its gradient written once (the
    parameters' are (C,) and (B, C)); ~8 f32 operations per element."""
    es = 2 if str(dtype) == "torch.bfloat16" else 4
    f, m = 8.0 * bsz * t * c / PEAK_F32_CORES, 2 * es * bsz * t * c / PEAK_BYTES
    return max(f, m) * 1e3, ("operations" if f >= m else "bytes")


def k2_backward_bound(bsz, t, c, co, dtype):
    """dx and dw of the k=3 conv (2 x 6 B T C Co); x, dy, w read, dx, dw,
    da, db, dbias written."""
    es = 2 if str(dtype) == "torch.bfloat16" else 4
    nbytes = es * (2 * bsz * t * c + bsz * t * co + 6 * co * c + co) \
        + 16 * bsz * c
    return bound(12.0 * bsz * t * c * co, nbytes, dtype)


def backward_calls() -> dict:
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention
    from ns2vc_tpu_torch.ops.fused_resnet import (
        affine_silu_conv1d, group_norm_affine,
    )

    k1, k2 = flash_attention.backward_calls, affine_silu_conv1d.backward_calls
    return {"flash_attention_f32tc": k1["f32tc"] + k1["f32tc_narrow"]
            + k1["f32tc_q1"],
            "flash_attention_f32tc_wgmma": k1["f32tc"],
            "flash_attention_tc": k1["tc"] + k1["tc_narrow"] + k1["tc_q1"],
            "flash_attention_tc_wgmma": k1["tc"],
            "affine_silu_conv1d_f32tc": k2["f32tc"],
            "affine_silu_conv1d_tc": k2["tc"],
            "group_norm_affine": group_norm_affine.backward_calls}


def grad_launches() -> dict:
    """Launches of K2's backward kernels per dtype since the last
    reset_launches(), by their kernels-line names."""
    from ns2vc_tpu_torch.ops.fused_resnet import affine_silu_conv1d_grad

    r = affine_silu_conv1d_grad.route_launches
    return {"affine_silu_conv1d_backward_bf16": r["bf16"],
            "affine_silu_conv1d_backward_f32": r["f32"]}


def k2_backward_case(x, a, b, w, bias, dy) -> dict:
    """K2's backward kernels on one input set against the plain backward
    (called under TF32 off): the largest error of the five gradients, of
    max |plain| each (the bf16 kernels' sums before rounding), a bitwise
    repeat, and device times in turns (kernels, cuDNN's path under the
    step's cuDNN flags, the same under cudnn.deterministic, and back):
    ms, plain (today's cuDNN path), plain_det, and the bound."""
    import torch

    from ns2vc_tpu_torch.ops.fused_resnet import (
        affine_silu_conv1d_backward, affine_silu_conv1d_grad,
    )

    got = affine_silu_conv1d_grad(x, a, b, w, bias, dy, keep_f32=True)
    again = affine_silu_conv1d_grad(x, a, b, w, bias, dy, keep_f32=True)
    want = affine_silu_conv1d_backward(x.float(), a, b, w.float(),
                                       bias.float(), dy.float())
    torch.cuda.synchronize()
    abs_err = [(g - e).abs().max().item() for g, e in zip(got, want)]
    err = max(d / max(e.abs().max().item(), 1e-30)
              for d, e in zip(abs_err, want))
    repeat = all(torch.equal(g, r) for g, r in zip(got, again))
    times = {"ms": [], "plain": [], "plain_det": []}

    def cudnn(det):
        # the training step's cuDNN flags (TF32 on, PyTorch's default),
        # deterministic as asked
        return torch.backends.cudnn.flags(
            enabled=True, benchmark=torch.backends.cudnn.benchmark,
            deterministic=det, allow_tf32=True)
    for which in ("ms", "plain", "plain_det", "plain_det", "plain", "ms"):
        if which == "ms":
            times[which].append(graph_ms(lambda: affine_silu_conv1d_grad(
                x, a, b, w, bias, dy)))
            continue
        with cudnn(which == "plain_det"):
            times[which].append(graph_ms(lambda: affine_silu_conv1d_backward(
                x, a, b, w, bias, dy)))
    bsz, t, c = x.shape
    bnd, by = k2_backward_bound(bsz, t, c, w.shape[0], x.dtype)
    return {"err": err, "abs_err": max(abs_err), "repeat": repeat,
            "bound": bnd, "bound_by": by,
            **{k: float(np.mean(v)) for k, v in times.items()}}


def median_step_ms(trainer, batches, warmup, timed, **kw):
    """Median wall ms of `timed` train steps on device-resident batches,
    each synchronised, after `warmup` steps; the peak memory (GB) of the
    timed steps; the last step's metrics."""
    import torch

    for i in range(warmup):
        trainer.train_step(batches[i % len(batches)], **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(timed):
        t0 = time.perf_counter()
        m = trainer.train_step(batches[i % len(batches)], **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not (torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])):
        fail(f"training: non-finite loss {m['loss']} or grad norm "
             f"{m['grad_norm']}")
    return float(np.median(times)), peak, m


def check_preprocess(tmp, cfg, cv_sd, dev):
    """Synthesized 44.1 kHz tone wavs -> the port's preprocess on the card
    (resampling, log-mel and the full-width seeded ContentVec through K1's
    f32 route on the card, DIO in a process pool). Returns the processed
    dir and the launches."""
    from ns2vc_tpu_torch.audio.host import read_wav, write_wav
    from ns2vc_tpu_torch.data.preprocess import preprocess_dataset
    from ns2vc_tpu_torch.features.contentvec import (
        content_frames, contentvec_from_state_dict,
    )

    sr = 44100
    raw = os.path.join(tmp, "raw")
    for i in range(TRAIN_WAVS):
        os.makedirs(os.path.join(raw, f"spk{i % 3}"), exist_ok=True)
        write_wav(os.path.join(raw, f"spk{i % 3}", f"{i}.wav"),
                  tone(int((4.5 + 0.25 * i) * sr), sr, SEED + 20 + i,
                       140.0 + 15 * i), sr)
    cv = contentvec_from_state_dict(cv_sd, heads=12)
    reset_launches()
    outs, ms = wall_ms(lambda: preprocess_dataset(
        raw, cfg, num_workers=4, contentvec=cv, device=dev))
    counts = route_counts()
    if len(outs) != TRAIN_WAVS or counts["flash_attention_f32tc"] == 0:
        fail(f"preprocess: {len(outs)} outputs, launches {counts}")
    for out in outs:
        wav, out_sr = read_wav(out)
        spec = np.load(out.replace(".wav", "") + ".spec.npy")
        f0 = np.load(out + ".f0.npy")
        soft = np.load(out + ".soft.npy")
        n16 = -(-len(wav) * 16000 // 24000)
        if out_sr != 24000 or spec.shape[:2] != (1, 100) \
                or abs(spec.shape[2] - len(f0)) > 2 \
                or soft.shape[:2] != (1, 256) \
                or abs(soft.shape[2] - content_frames(n16)) > 1 \
                or not all(np.isfinite(a).all() for a in (spec, f0, soft)) \
                or (f0 > 0).mean() < 0.5:
            fail(f"preprocess: {out}: wav {len(wav)} at {out_sr}, spec "
                 f"{spec.shape}, f0 {f0.shape} voiced {(f0 > 0).mean():.2f}, "
                 f"soft {soft.shape}")
    say(f"preprocess on the card: {TRAIN_WAVS} wavs (4.5-7.25 s at 44.1 kHz)"
        f" -> 24 kHz wav, f0, (1, 100, T) log-mel, (1, 256, T50) ContentVec "
        f"(full width, f32); {ms:.0f} ms; launches {counts} [{CARD}]")
    return raw + "_processed", counts


def training_config(processed, logs):
    import dataclasses

    from ns2vc_tpu_torch.config import Config

    base = Config()
    return dataclasses.replace(
        base,
        train=dataclasses.replace(
            base.train, train_batch_size=TRAIN_B, num_workers=4,
            use_ema=True, log_every=5, save_and_sample_every=10 ** 9,
            logs_folder=logs),
        data=dataclasses.replace(base.data, training_files=processed,
                                 val_files=processed))


def check_train_geometries(calls, dev):
    """Every K1 / K2 geometry of one bf16 training step (remat off: one
    call per backward), forward and backward through the Function against
    autograd through the plain version, on random inputs laid out as the
    step's; the forward timed as in the serving phases, the backward (K1's
    torch ops, K2's backward kernels) timed as a CUDA graph. At every K2
    geometry K2's backward kernels, in bf16 and in f32, against the plain
    backward (`k2_backward_case`). Returns per route {fwd_ms, bwd_ms,
    bwd_bound, bwd_by, err, plain_ms, lib_ms, bound} summed over the
    step's calls (K2's also bwd_plain_ms, cuDNN's path), and per backward
    kernel route {ms, plain, plain_det, bound, bound_by, err, abs_err,
    calls}."""
    from unittest import mock

    import torch

    import ns2vc_tpu_torch.ops.fused_resnet as fr
    from ns2vc_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward, flash_attention_plain,
    )
    from ns2vc_tpu_torch.ops.fused_resnet import (
        gn_silu_conv1d, group_norm_affine, group_norm_affine_plain,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    out = defaultdict(lambda: defaultdict(float))
    worst = defaultdict(float)
    bwd_out = defaultdict(lambda: defaultdict(float))   # K2's backward

    def add(route, key, value, n):
        out[route][key] += n * value

    for key, n in calls.k1.items():
        geo, dtype, scale, _ = key
        bias = calls.bias[key]
        bufs = [torch.randn(size, generator=g, device=dev).to(dtype)
                .requires_grad_() for _, _, _, size in geo]
        views = [b_.as_strided(shape, stride, offset)
                 for b_, (shape, stride, offset, _) in zip(bufs, geo)]
        q, k, v = views
        s = q.shape[-1] ** -0.5 if scale is None else scale
        do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        o = flash_attention(q, k, v, bias, scale)
        o.backward(do)
        got = [b_.grad for b_ in bufs]
        ref = [b_.detach().requires_grad_() for b_ in bufs]
        flash_attention_plain(*(r_.as_strided(shape, stride, offset)
                                for r_, (shape, stride, offset, _)
                                in zip(ref, geo)), bias, scale).backward(do)
        err = max((a.float() - b_.grad.float()).abs().max().item()
                  / max(1.0, b_.grad.float().abs().max().item())
                  for a, b_ in zip(got, ref))
        route = k1_route(dtype)
        worst[route] = max(worst[route], err)
        if not err <= K1_GRAD_BF16:
            fail(f"K1 backward q{tuple(q.shape)} k{tuple(k.shape)}: error "
                 f"{err} > {K1_GRAD_BF16} of max(1, max|grad|)")
        qd, kd, vd = (t.detach() for t in (q, k, v))
        r = k1_case(qd, kd, vd, bias, scale)
        add(route, "fwd_ms", r["ms"], n)
        if r.get("old") is not None:
            add(route, "old_fwd_ms", r["old"], n)
        add(route, "plain_ms", r["plain"], n)
        add(route, "lib_ms", r["lib"], n)
        add(route, "bound", r["bound"], n)
        add(route, "bwd_ms", graph_ms(lambda: flash_attention_backward(
            qd, kd, vd, bias, s, do)), n)
        bb, by = k1_backward_bound(qd, kd, bias)
        add(route, "bwd_bound", bb, n)
        out[route]["bwd_by_" + by] += n * bb
        out[route]["calls"] += n

    for key, n in calls.k2.items():
        (bsz, t, c), dtype, co = key
        x = torch.randn(bsz, t, c, generator=g, device=dev).to(dtype)
        gamma = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
        beta = (0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
        w = (torch.randn(co, c, 3, generator=g, device=dev)
             / (3 * c) ** 0.5).to(dtype)
        bias = (0.1 * torch.randn(co, generator=g, device=dev)).to(dtype)
        film = [(0.2 * torch.randn(bsz, c, generator=g, device=dev))
                .to(dtype) for _ in range(2)]
        dy = torch.randn(bsz, t, co, generator=g, device=dev).to(dtype)

        def run():
            args = [a.detach().requires_grad_()
                    for a in (x, gamma, beta, w, bias, *film)]
            gn_silu_conv1d(*args[:5], 8, 1e-5, film_scale=args[5],
                           film_shift=args[6]).backward(dy)
            return [a.grad for a in args]
        got = run()
        with mock.patch.object(fr, "affine_silu_conv1d",
                               fr.affine_silu_conv1d_plain), \
                mock.patch.object(fr, "group_norm_affine",
                                  group_norm_affine_plain):
            want = run()
        err = max((a.float() - b_.float()).abs().max().item()
                  / max(1.0, b_.float().abs().max().item())
                  for a, b_ in zip(got, want))
        route = k2_route(dtype)
        worst[route] = max(worst[route], err)
        if not err <= K2_GRAD_BF16:
            fail(f"K2 backward B={bsz} T={t} C={c} Co={co}: error {err} > "
                 f"{K2_GRAD_BF16} of max(1, max|grad|)")
        r = k2_case(bsz, t, c, co, True, dtype, g, dev)
        add(route, "fwd_ms", r["ms"], n)
        add(route, "plain_ms", r["plain"], n)
        add(route, "conv_ms", r["conv"], n)
        add(route, "bound", r["bound"], n)
        a, b = group_norm_affine(x, gamma, beta, 8, 1e-5, *film)
        # the backward kernels against the plain backward, in the step's
        # dtype and in f32, timed in turns against cuDNN's path in both
        # modes
        for kd in (dtype, torch.float32):
            kb = k2_backward_case(*(v.to(kd) if v.dtype != torch.float32
                                    or kd == torch.float32 else v
                                    for v in (x, a, b, w, bias, dy)))
            name = ("affine_silu_conv1d_backward_bf16"
                    if kd == torch.bfloat16 else
                    "affine_silu_conv1d_backward_f32")
            if not (kb["err"] <= K2_BWD_RTOL and kb["repeat"]):
                fail(f"K2 backward kernels ({kd}) B={bsz} T={t} C={c} "
                     f"Co={co}: error {kb['err']:.3e} of max|plain| (tol "
                     f"{K2_BWD_RTOL}), two launches bitwise equal: "
                     f"{kb['repeat']}")
            d = bwd_out[name]
            d["err"] = max(d["err"], kb["err"])
            d["abs_err"] = max(d["abs_err"], kb["abs_err"])
            for k in ("ms", "plain", "plain_det", "bound"):
                d[k] += n * kb[k]
            d["by_" + kb["bound_by"]] += n * kb["bound"]
            d["calls"] += n
            if kd == dtype:   # the step's backward: the kernels
                add(route, "bwd_ms", kb["ms"], n)
                add(route, "bwd_plain_ms", kb["plain"], n)
        bb, by = k2_backward_bound(bsz, t, c, co, dtype)
        add(route, "bwd_bound", bb, n)
        out[route]["bwd_by_" + by] += n * bb
        out[route]["calls"] += n
        # the statistics kernel: its backward recomputes the plain version
        # under autograd (a, b's gradients of the K2 call)
        st, st_route = r["stats"], gn_route(dtype)
        worst[st_route] = max(worst[st_route], st["err"])
        for key, value in (("fwd_ms", st["ms"]), ("plain_ms", st["plain"]),
                           ("lib_ms", st["lib"]), ("bound", st["bound"])):
            add(st_route, key, value, n)
        leaves = [v.detach().requires_grad_() for v in (x, gamma, beta,
                                                        *film)]
        da, db = torch.randn_like(a), torch.randn_like(b)

        def stats_backward():
            return torch.autograd.grad(group_norm_affine_plain(
                *leaves[:3], 8, 1e-5, *leaves[3:]), leaves, (da, db))
        add(st_route, "bwd_ms", graph_ms(stats_backward), n)
        bb, by = gn_backward_bound(bsz, t, c, dtype)
        add(st_route, "bwd_bound", bb, n)
        out[st_route]["bwd_by_" + by] += n * bb
        out[st_route]["calls"] += n
    for route, d in out.items():
        d["err"] = worst[route]
        by = {k[7:]: v for k, v in d.items() if k.startswith("bwd_by_")}
        d["bwd_by"] = max(by, key=by.get)
        stats = route.startswith("group_norm")
        say(f"{route} at the training step's {int(d['calls'])} calls (B="
            f"{TRAIN_B}, bf16): "
            + ("forward vs plain worst " if stats else
               "backward vs plain autograd worst ")
            + f"{d['err']:.3e}" + ("" if stats else " of max(1, max|grad|)")
            + f"; device ms per step: "
            f"forward {d['fwd_ms']:.4f} (plain {d['plain_ms']:.4f}"
            + (f", {'var_mean' if stats else 'SDPA'} {d['lib_ms']:.4f}"
               if d.get("lib_ms") else "")
            + (f", conv alone {d['conv_ms']:.4f}" if d.get("conv_ms") else "")
            + (f", mma.sync kernel {d['old_fwd_ms']:.4f}"
               if d.get("old_fwd_ms") else "")
            + f", bound {d['bound']:.5f}), "
            + ("backward kernels" if d.get("bwd_plain_ms") else
               "torch backward") + f" {d['bwd_ms']:.4f} "
            + (f"(cuDNN's path {d['bwd_plain_ms']:.4f}) "
               if d.get("bwd_plain_ms") else "")
            + f"(bound {d['bwd_bound']:.5f}, {d['bwd_by']}) [{CARD}]")
    for name, d in bwd_out.items():
        by = {k[3:]: v for k, v in d.items() if k.startswith("by_")}
        d["bound_by"] = max(by, key=by.get)
        say(f"{name} at the training step's {int(d['calls'])} K2 calls (B="
            f"{TRAIN_B}): worst error {d['err']:.3e} of max|plain| (tol "
            f"{K2_BWD_RTOL}), two launches bitwise equal at every geometry;"
            f" device ms per step in turns: kernels {d['ms']:.4f}, cuDNN's "
            f"path {d['plain']:.4f}, under cudnn.deterministic "
            f"{d['plain_det']:.4f} (bound {d['bound']:.5f}, {d['bound_by']}"
            f") [{CARD}]")
        out[name] = d
    return out


@contextlib.contextmanager
def relu_gates(gates: list, replay: list | None = None):
    """`torch.relu` that records each call's gate (h > 0) into `gates`, or,
    with `replay`, takes the recorded gate of the same call in place of its
    own (h * gate: the gradient flows where the recording run's did) and
    appends to `replay` how many of its own gates differ. A pre-activation
    within rounding of 0 opens the gate on one device and closes it on
    another; under loss_f0, an L1 that gives every frame an equal share,
    each such element moves a parameter's gradient by about one frame's
    share (~1/(B*T) of its max), so two f32 runs of the same step agree to
    ~1e-6 on one gate pattern and to ~1e-3 across two
    (scripts/torch_f0_grad_precision.py)."""
    from unittest import mock

    import torch

    relu = torch.relu

    def recording(h):
        gates.append((h > 0).cpu())
        return relu(h)

    def replaying(h):
        if len(replay) == len(gates) or gates[len(replay)].shape != h.shape:
            fail(f"relu gates: call {len(replay)} takes {tuple(h.shape)}, "
                 f"the recording made {len(gates)} calls")
        gate = gates[len(replay)].to(h.device)
        replay.append(int(((h > 0) != gate).sum()))
        return h * gate.to(h.dtype)
    with mock.patch.object(torch, "relu",
                           recording if replay is None else replaying):
        yield
    if replay is not None and len(replay) != len(gates):
        fail(f"relu gates: the replay made {len(replay)} calls, the "
             f"recording {len(gates)}")


def check_grads(cfg, sd, batch, dev, states=(), provenance=None):
    """One step's gradients at full width, B=2 x 272, p_dropout 0, remat
    dots: f32 on the card (the f32 kernels, TF32 off) against f32 on the
    CPU (the plain versions, on the card run's ReLU gates: `relu_gates`),
    each tensor within GRAD_RTOL of max(1e-3, max|g|); then the bf16 step
    on the card (tensor-core kernels) against the CPU's f32 gradients,
    cosine >= GRAD_COSINE per tensor, leaving out the tensors whose f32
    gradient the card does not reproduce to cosine 0.999 (zero in exact
    arithmetic: their values are rounding noise). Before the bf16 check
    decides, `bf16_witness` measures how far bf16's own rounding moves
    these cosines at this state and at `states` (state dicts of the same
    model), and prints it. When the bf16 check fails, `provenance(sd)`
    (the steps, batches and seeds that made the state, and its hash) is
    printed before the script exits, so that the state can be rebuilt."""
    import dataclasses
    from unittest import mock

    import torch

    import ns2vc_tpu_torch.ops.attention as attention
    import ns2vc_tpu_torch.ops.fused_resnet as fused_resnet
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention_plain
    from ns2vc_tpu_torch.ops.fused_resnet import affine_silu_conv1d_plain
    from ns2vc_tpu_torch.utils.precision import cast_floating, parameters_as

    enc = dataclasses.replace(cfg.phoneme_encoder, p_dropout=0.0)
    cfg0 = dataclasses.replace(cfg, phoneme_encoder=enc,
                               prompt_encoder=dataclasses.replace(
                                   cfg.prompt_encoder, p_dropout=0.0))
    gen = torch.Generator().manual_seed(SEED + 31)
    t = torch.randint(0, 1000, (2,), generator=gen)
    noise = torch.randn(2, TRAIN_T, 100, generator=gen)
    small = {k: v[:2].float() if v.is_floating_point() else v[:2]
             for k, v in batch.items()}
    models, loaded = {}, {}

    def grads(device, dtype=torch.float32, rows=small, t=t, noise=noise,
              state=sd):
        model = models.get(device.type)
        if model is None:
            model = NaturalSpeech2(cfg0, remat=True, remat_policy="dots")
            model.to(device).train()
            models[device.type] = model
        if loaded.get(device.type) is not state:
            model.load_state_dict(state)
            loaded[device.type] = state
        model.zero_grad(set_to_none=True)
        b = {k: v.to(device) for k, v in rows.items()}
        cast = {}
        if dtype != torch.float32:
            cast = cast_floating(dict(model.named_parameters()), dtype)
            b = cast_floating(b, dtype)
        with parameters_as(model, cast):
            loss, _ = model(b, t=t.to(device), noise=noise.to(device))
            loss.backward()
        return loss.item(), {n: p.grad.detach().cpu().double()
                             for n, p in model.named_parameters()}

    gates, replay = [], []
    with no_tf32():
        reset_launches()
        with relu_gates(gates):
            (l_card, g_card), ms = wall_ms(lambda: grads(dev))
        f32_grads, f32_bwd = grad_launches(), backward_calls()
        if f32_grads["affine_silu_conv1d_backward_f32"] != \
                f32_bwd["affine_silu_conv1d_f32tc"] or not f32_grads[
                    "affine_silu_conv1d_backward_f32"]:
            fail(f"f32 gradients on the card: K2's backward kernels "
                 f"launched {f32_grads}, K2's f32 backward calls "
                 f"{f32_bwd['affine_silu_conv1d_f32tc']}")
        with relu_gates(gates, replay):
            l_cpu, g_cpu = grads(torch.device("cpu"))
    models.pop("cpu"), loaded.pop("cpu")
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        err = (g_card[name] - want).abs().max().item() / max(
            1e-3, want.abs().max().item())
        if not np.isfinite(err) or err > GRAD_RTOL:
            fail(f"card vs CPU gradient {name}: {err:.3e} of max(1e-3, "
                 f"max|g|) > {GRAD_RTOL}")
        if err >= worst:
            worst, worst_name = err, name
    say(f"training gradients at full width, f32 (TF32 off), B=2 x "
        f"{TRAIN_T}, card (f32 kernels) vs CPU (plain) on the card's ReLU "
        f"gates: loss {l_card:.6f} vs {l_cpu:.6f}; {len(g_cpu)} tensors, "
        f"worst {worst_name} {worst:.3e} of max(1e-3, max|g|) (tol "
        f"{GRAD_RTOL:g}); gates the CPU would set otherwise: {sum(replay)} "
        f"of {sum(g.numel() for g in gates)}; card step {ms:.0f} ms")

    def plain_grads(rows=small, t=t, noise=noise, state=sd, k1=True,
                    k2=True, k1_where=None):
        """bf16 grads with K1 (only the calls `k1_where(q)` picks, when
        given) and / or K2 through their plain versions."""
        k1_fn = flash_attention_plain
        if k1_where is not None:
            kern = attention.flash_attention

            def k1_fn(q, *a, **kw):
                return (flash_attention_plain if k1_where(q) else kern)(
                    q, *a, **kw)
        with contextlib.ExitStack() as stack:
            if k1:
                stack.enter_context(mock.patch.object(
                    attention, "flash_attention", k1_fn))
            if k2:
                stack.enter_context(mock.patch.object(
                    fused_resnet, "affine_silu_conv1d",
                    affine_silu_conv1d_plain))
                stack.enter_context(mock.patch.object(
                    fused_resnet, "group_norm_affine",
                    fused_resnet.group_norm_affine_plain))
            return grads(dev, torch.bfloat16, rows, t, noise, state)[1]

    l_bf16, g_bf16 = grads(dev, torch.bfloat16)
    # the same bf16 step through the plain versions: bf16's own rounding
    g_plain = plain_grads()
    noise_floor = sorted(n for n in g_cpu
                         if cosine(g_card[n], g_cpu[n]) < 0.999)
    cos = {n: cosine(g_bf16[n], g_cpu[n]) for n in g_cpu
           if n not in noise_floor}
    cos_plain = {n: cosine(g_plain[n], g_cpu[n]) for n in cos}
    low = min(cos, key=cos.get)
    gap = max(cos, key=lambda n: cos_plain[n] - cos[n])
    say(f"training gradients, bf16 through the tensor-core kernels vs f32 "
        f"plain (CPU): loss {l_bf16:.6f} vs {l_cpu:.6f}; worst cosine "
        f"{cos[low]:.5f} ({low}; bf16 through the plain versions "
        f"{cos_plain[low]:.5f}) over {len(cos)} tensors; largest loss of "
        f"cosine to the kernels {cos_plain[gap] - cos[gap]:.2e} ({gap}); "
        f"left out as rounding noise (f32 card vs CPU cosine < 0.999): "
        f"{noise_floor}")
    # a tensor passes at GRAD_COSINE, or where bf16 itself (the plain
    # versions in bf16) does not reach it, within BF16_COSINE_GAP of that
    bad = [n for n in cos if not (cos[n] >= GRAD_COSINE or
                                  cos[n] >= cos_plain[n] - BF16_COSINE_GAP)]
    witness = bf16_witness(grads, plain_grads, batch, g_card, cos,
                           cos_plain, states, dev)
    models.clear()
    if bad or len(noise_floor) > 8:
        if provenance is not None:
            say("bf16 gradient check state: " + json.dumps(provenance(sd)))
        fail(f"bf16 gradients: {[(n, cos[n], cos_plain[n]) for n in bad]} "
             f"below {GRAD_COSINE} and the plain bf16 cosine, or "
             f"{len(noise_floor)} tensors at the noise floor")
    return {"grad_f32_worst": worst, "grad_f32_worst_tensor": worst_name,
            "grad_f32_backward_launches": f32_grads[
                "affine_silu_conv1d_backward_f32"],
            "grad_bf16_cosine": cos[low], "grad_bf16_worst_tensor": low,
            "grad_bf16_plain_cosine": cos_plain[low],
            "grad_bf16_below_target": sorted(
                n for n in cos if cos[n] < GRAD_COSINE),
            "grad_noise_floor": noise_floor, "bf16_witness": witness}


def cosine(a, b) -> float:
    return (a.flatten() @ b.flatten()).item() / max(
        a.norm().item() * b.norm().item(), 1e-300)


POOL = ".pool."               # the two attention pools' tensors
WITNESS_DRAWS = 3             # further draws of rows, t and noise
WITNESS_STATES = 4            # further states: other batch orders
WITNESS_STEPS = 10            # steps from the pre-loop state to each


def bf16_witness(grads, plain_grads, batch, g_card, cos, cos_plain, states,
                 dev) -> dict:
    """How much bf16's own rounding moves the per-tensor cosines of the
    bf16 gradients, so that a gap between the kernels' and the plain
    versions' bf16 cosines can be read against it. Four bf16 steps of
    the checked draw, each rounding differently: through the kernels
    (twice: is the step repeatable?), the plain versions, K1 plain (K2's
    kernel) and K2 plain (K1's kernel); and:

    - at the checked state: the pools' K1 calls alone plain, and every
      K1 call but the pools' plain; WITNESS_DRAWS further draws (other
      rows of the batch, other t and noise) through the kernels and the
      plain versions, each against its own f32 card reference (TF32 off);
    - at each of `states` (the state before the loader-fed loop, trained
      on by WITNESS_STEPS steps of batches in another order, as an
      unordered loader would hand them out): the checked draw through
      the four routes against the state's f32 card reference;
    - at the checked state, WITNESS_DRAWS draws of the batch's first two
      rows with the prompt cut to the shortest the loader makes (133
      frames, zero-padded to the geometry) through the four routes;
    - per case the worst cosine over the pools' tensors and over all, and
      how many tensors the check's rule fails with the kernels tested
      against the plain versions, and with the two swapped;
    - K1 alone on the inputs and output gradient the bf16 step gives each
      pool's attention (one query; the speaker pool 1 head of 100, the
      UNet's 64 heads of 4): forward and backward through the kernel and
      through the plain version, each against f64, relative max error
      and cosine.

    Prints every number and returns them; decides nothing."""
    from unittest import mock

    import torch

    import ns2vc_tpu_torch.ops.attention as attention
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention_plain

    names = list(cos)
    pools = [n for n in names if POOL in n]
    out = {"pools": {n: [cos[n], cos_plain[n]] for n in pools}}

    def summary(routes: dict) -> dict:
        """Worst pool and overall cosine per route, and the rule's fails
        kernels-vs-plain and plain-vs-kernels."""
        res = {r: [min(c[n] for n in pools), min(c.values())]
               for r, c in routes.items()}
        ck, cp = routes["kernels"], routes["plain"]
        for key, (a, b) in (("fails", (ck, cp)), ("fails_swapped",
                                                  (cp, ck))):
            res[key] = sum(1 for n in names if not (
                a[n] >= GRAD_COSINE or a[n] >= b[n] - BF16_COSINE_GAP))
        return res

    def cosines(g, ref):
        return {n: cosine(g[n], ref[n]) for n in names}

    def four(ref, **kw):
        return {"kernels": cosines(grads(dev, torch.bfloat16, **kw)[1], ref),
                "plain": cosines(plain_grads(**kw), ref),
                "K1 plain": cosines(plain_grads(k2=False, **kw), ref),
                "K2 plain": cosines(plain_grads(k1=False, **kw), ref)}

    def line(res):
        return " ".join(f"{r} {v[0]:.4f}/{v[1]:.4f}" for r, v in res.items()
                        if isinstance(v, list)) + \
            f"; rule fails {res['fails']}, swapped {res['fails_swapped']}"

    routes = four(g_card)
    routes["kernels"], routes["plain"] = cos, cos_plain
    routes["kernels again"] = cosines(grads(dev, torch.bfloat16)[1], g_card)
    routes["pools' K1 plain"] = cosines(plain_grads(
        k2=False, k1_where=lambda q: q.shape[2] == 1), g_card)
    routes["K1 plain but the pools'"] = cosines(plain_grads(
        k2=False, k1_where=lambda q: q.shape[2] != 1), g_card)
    out["checked"] = summary(routes)
    say("bf16 witness, the checked state and draw (worst cosine over the "
        "pools' tensors / over all, per route): " + line(out["checked"]))

    out["draws"] = []
    n_rows = batch["c"].shape[0]
    for j in range(WITNESS_DRAWS):
        gen = torch.Generator().manual_seed(SEED + 101 + j)
        pick = torch.randperm(n_rows, generator=gen)[:2]
        rows = {k: (v[pick].float() if v.is_floating_point() else v[pick])
                for k, v in batch.items()}
        t = torch.randint(0, 1000, (2,), generator=gen)
        noise = torch.randn(2, TRAIN_T, 100, generator=gen)
        with no_tf32():
            ref = grads(dev, torch.float32, rows, t, noise)[1]
        out["draws"].append(summary({
            "kernels": cosines(grads(dev, torch.bfloat16, rows, t,
                                     noise)[1], ref),
            "plain": cosines(plain_grads(rows, t, noise), ref)}))
        say(f"bf16 witness, draw {j} (t {t.tolist()}): "
            + line(out["draws"][-1]))

    # the shortest prompt the loader cuts (a third of a 400-frame crop):
    # the speaker pool pools the padded mel without a mask, so most of its
    # keys are then one padded row
    short = 400 // 3
    rows = {k: (v[:2].float() if v.is_floating_point() else v[:2]).clone()
            for k, v in batch.items()}
    rows["refer"][:, short:] = 0.0
    rows["refer_lengths"] = rows["refer_lengths"].clamp(max=short)
    out["short_prompt"] = []
    for j in range(WITNESS_DRAWS):
        gen = torch.Generator().manual_seed(SEED + 201 + j)
        t = torch.randint(0, 1000, (2,), generator=gen)
        noise = torch.randn(2, TRAIN_T, 100, generator=gen)
        with no_tf32():
            ref = grads(dev, torch.float32, rows, t, noise)[1]
        out["short_prompt"].append(summary(four(ref, rows=rows, t=t,
                                                noise=noise)))
        say(f"bf16 witness, a {short}-frame prompt, draw {j} (t "
            f"{t.tolist()}): " + line(out["short_prompt"][-1]))

    out["states"] = []
    for j, state in enumerate(states):
        with no_tf32():
            ref = grads(dev, torch.float32, state=state)[1]
        res = summary(four(ref, state=state))
        out["states"].append(res)
        say(f"bf16 witness, state {j} (other batch order): " + line(res))

    # K1 alone at each pool's call
    seen = []
    kern = attention.flash_attention

    def capture(q, k, v, bias=None, scale=None):
        o = kern(q, k, v, bias, scale)
        if q.shape[2] == 1 and o.requires_grad:
            call = {"q": q.detach().clone(), "k": k.detach().clone(),
                    "v": v.detach().clone(), "bias": bias, "scale": scale}
            seen.append(call)
            o.register_hook(lambda g: call.setdefault("do",
                                                      g.detach().clone()))
        return o
    with mock.patch.object(attention, "flash_attention", capture):
        grads(dev, torch.bfloat16)

    def run(call, fn, dtype):
        xs = [call[x].to(dtype).clone().requires_grad_()
              for x in ("q", "k", "v")]
        o = fn(*xs, call["bias"], call["scale"])
        o.backward(call["do"].to(dtype))
        return [o.detach().double()] + [x.grad.double() for x in xs]
    out["k1_pools"] = []
    for call in seen:
        want = run(call, flash_attention_plain, torch.float64)
        k1 = {"q": list(call["q"].shape), "k": list(call["k"].shape)}
        for name, fn in (("kernel", kern), ("plain", flash_attention_plain)):
            got = run(call, fn, torch.bfloat16)
            k1[name] = {part: [((g - w).abs().max()
                                / w.abs().max()).item(), cosine(g, w)]
                        for part, g, w in zip(("o", "dq", "dk", "dv"), got,
                                              want)}
        out["k1_pools"].append(k1)
        say(f"bf16 witness, K1 alone at a pool's call (q {tuple(k1['q'])}, "
            f"k/v {tuple(k1['k'])}, bf16, its own dO) vs f64, relative max "
            f"error / cosine: " + "; ".join(
                f"{name} " + ", ".join(f"{p} {e:.2e}/{c:.6f}"
                                       for p, (e, c) in k1[name].items())
                for name in ("kernel", "plain")))
    return out


def witness_states(trainer, cfg, snap: dict) -> list:
    """WITNESS_STATES state dicts (on the CPU) for `bf16_witness`: the
    trainer restored to `snap` (`snapshot`) and trained WITNESS_STEPS
    steps on batches in another order each (the synced loader with
    another seed, serial); the trainer is left as it was found."""
    from ns2vc_tpu_torch.data.dataset import synced_data_loader

    here = snapshot(trainer)
    states = []
    for j in range(WITNESS_STATES):
        restore(trainer, snap)
        loader = synced_data_loader(
            trainer.ds, trainer._collator, TRAIN_B,
            seed=cfg.train.seed + 1 + j, shard_index=0, shard_count=1)
        for _ in range(WITNESS_STEPS):
            trainer.train_step(trainer.device_batch(next(loader)))
        loader.close()
        states.append({k: v.detach().to("cpu", copy=True) for k, v in
                       trainer.model.state_dict().items()})
    restore(trainer, here)
    return states


def _opt_params(trainer) -> list:
    return [p for g in trainer.state.optimizer.param_groups
            for p in g["params"]]


def snapshot(trainer) -> dict:
    """A copy of what a train step changes: parameters, optimizer state
    (per parameter, in the optimizer's order), EMA and step."""
    opt = trainer.state.optimizer.state
    return {"model": {k: v.detach().clone() for k, v in
                      trainer.model.state_dict().items()},
            "opt": [{k: v.clone() for k, v in opt[p].items()}
                    for p in _opt_params(trainer)],
            "ema": {k: v.clone() for k, v in
                    (trainer.state.ema_params or {}).items()},
            "step": trainer.state.step}


def restore(trainer, snap: dict) -> None:
    """Back to a `snapshot`, copied into the live tensors: the step
    programs' graphs hold their addresses (an optimizer's load_state_dict
    would replace them and drop the programs). A parameter the snapshot's
    optimizer held no state for (a trainer that had not stepped) loses its
    state, which the next step makes anew: drop the programs after such a
    restore."""
    import torch

    trainer.model.load_state_dict(snap["model"])
    opt = trainer.state.optimizer.state
    with torch.no_grad():
        for p, saved in zip(_opt_params(trainer), snap["opt"]):
            if not saved:
                opt.pop(p, None)
            for k, v in saved.items():
                opt[p][k].copy_(v)
    for k, v in snap["ema"].items():
        trainer.state.ema_params[k].copy_(v)
    trainer.state.step = snap["step"]


def state_differs(trainer, a: dict, b: dict) -> list:
    """The names of the tensors in which two `snapshot`s of the trainer
    differ, bit for bit."""
    from torch import equal

    names = [n for n, _ in trainer.model.named_parameters()]
    out = [f"step {a['step']} vs {b['step']}"] if a["step"] != b["step"] \
        else []
    out += [f"parameter {k}" for k in a["model"]
            if not equal(a["model"][k], b["model"][k])]
    out += [f"AdamW {k} of {names[i]}" for i, (x, y) in enumerate(
        zip(a["opt"], b["opt"])) for k in x if not equal(x[k], y[k])]
    out += [f"EMA {k}" for k in a["ema"]
            if not equal(a["ema"][k], b["ema"][k])]
    return out


def check_training(vsd, cv_sd, dev, tmp):
    """Preprocess on the card, then train Config() at full width, B=32 x
    272, bf16, remat dots through the Trainer: launches and backward calls
    per step, step time and peak memory for remat dots / off / all, the
    loss on one fixed batch over LOSS_STEPS steps, the trainer's own loop
    with a loader, every K1 / K2 training geometry forward and backward,
    card vs CPU gradients, a checkpoint round trip, and one request served
    from the checkpoint."""
    from unittest import mock

    import torch

    from ns2vc_tpu_torch.convert import load_checkpoint
    from ns2vc_tpu_torch.data.dataset import (
        data_loader, synced_data_loader, synced_schedule,
    )
    from ns2vc_tpu_torch.infer.svc import Svc
    from ns2vc_tpu_torch.models.unet import ResnetBlock1D
    from ns2vc_tpu_torch.ops import fused_resnet as fr
    from ns2vc_tpu_torch.train.trainer import Trainer

    res = {}
    base = training_config(tmp, os.path.join(tmp, "logs"))
    processed, res["preprocess_launches"] = check_preprocess(tmp, base, cv_sd,
                                                             dev)
    cfg = training_config(processed, os.path.join(tmp, "logs"))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, logs_folder=os.path.join(tmp, "run"),
                      vocos_params=vsd, device=dev)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    # every batch of this phase comes in the same order in every run, so
    # the state the gradient checks see at its end is the same: the timed
    # steps' from a serial loader, the loop's from the synced loader
    # (spawned workers, re-sequenced; the trainer's data_loader hands its
    # workers' batches out in the order they finish)
    serial = data_loader(trainer.ds, trainer._collator, TRAIN_B,
                         seed=cfg.train.seed)
    serial_items = []
    getitem = type(trainer.ds).__getitem__
    with mock.patch.object(type(trainer.ds), "__getitem__",
                           lambda ds, i: serial_items.append(i)
                           or getitem(ds, i)):
        batches = [trainer.device_batch(next(serial)) for _ in range(4)]
    serial.close()
    # each step that makes the state the gradient checks see: its number,
    # its batch (by object), and whether t and noise were given; through
    # the step programs or eagerly
    steps_log = []

    def logged(step_fn):
        def f(b, *args, **kw):
            steps_log.append((trainer.step, id(b), "t" in kw))
            return step_fn(b, *args, **kw)
        return f
    trainer.train_step = logged(trainer.train_step)
    trainer._train_step_eager = logged(trainer._train_step_eager)
    trainer.dl = synced_data_loader(
        trainer.ds, trainer._collator, TRAIN_B, seed=cfg.train.seed,
        num_workers=trainer.num_workers, shard_index=0, shard_count=1)
    b0 = batches[0]
    if tuple(b0["c"].shape) != (TRAIN_B, TRAIN_T, 256) or \
            b0["c"].dtype != torch.bfloat16 or \
            tuple(b0["refer"].shape) != (TRAIN_B, TRAIN_T, 100):
        fail(f"training batch: c {tuple(b0['c'].shape)} {b0['c'].dtype}, "
             f"refer {tuple(b0['refer'].shape)}")
    say(f"trainer: Config() at full width, {n_params / 1e6:.1f} M "
        f"parameters (f32 masters, bf16 forward), batch {TRAIN_B} x "
        f"{TRAIN_T}, set up in {time.perf_counter() - t0:.1f} s")
    unet = trainer.model.diff_model.unet

    # launches and backward calls of one step (remat dots): a replay of
    # the step program (the key's first call: warm-up and capture), then
    # an eager step, which must launch the same
    t1 = time.perf_counter()
    trainer.train_step(b0)
    torch.cuda.synchronize()
    res["first_call_ms"] = (time.perf_counter() - t1) * 1e3
    reset_launches()
    trainer.train_step(batches[1])
    torch.cuda.synchronize()
    launches, bwd, grads = route_counts(), backward_calls(), grad_launches()
    reset_launches()
    packs = []
    pack = fr.pack_conv_weight
    with mock.patch.object(fr, "pack_conv_weight",
                           lambda w: packs.append(1) or pack(w)):
        trainer._train_step_eager(batches[2])
    torch.cuda.synchronize()
    if route_counts() != launches or backward_calls() != bwd \
            or grad_launches() != grads:
        fail(f"training step: a replay counts launches {launches}, "
             f"backward calls {bwd} and backward kernels {grads}, the eager "
             f"step {route_counts()}, {backward_calls()} and "
             f"{grad_launches()}")
    # every K2 backward of the step ran on the backward kernels
    if grads != {"affine_silu_conv1d_backward_bf16": 45,
                 "affine_silu_conv1d_backward_f32": 0}:
        fail(f"training step: K2's backward kernels launched {grads}, not "
             f"once per K2 backward (45 bf16)")
    res["grad_launches"] = grads
    # the step's fresh bf16 weights are packed once each; the recomputed
    # forward finds them in the cache
    if len(packs) != 45:
        fail(f"training step packed K2 weights {len(packs)} times, not 45")
    want = {"flash_attention_f32tc": 0, "flash_attention_f32tc_q1": 0,
            "flash_attention_tc": 46 + 32,
            "flash_attention_f32tc_narrow": 0,
            "flash_attention_tc_narrow": 0,
            "flash_attention_tc_q1": 2, "affine_silu_conv1d_f32tc": 0,
            "affine_silu_conv1d_f32tc_elem": 0,
            "affine_silu_conv1d_tc": 45 + 44, "affine_silu_conv1d_tc_elem": 0,
            "group_norm_affine": 45 + 44}
    want_bwd = {"flash_attention_f32tc": 0, "flash_attention_tc": 46,
                "affine_silu_conv1d_f32tc": 0, "affine_silu_conv1d_tc": 45,
                "group_norm_affine": 45}
    if route_totals(launches) != want or route_totals(bwd) != want_bwd:
        fail(f"training step launches {launches} (expected {want}), "
             f"backward calls {bwd} (expected {want_bwd})")
    res["launches"], res["backward"] = launches, bwd
    say(f"training step (remat dots): launches {launches}; backward calls "
        f"{bwd}; K2's backward kernels {grads} (a replay and the eager step "
        f"alike); K2 weights packed "
        f"{len(packs)} times (eager); the step key's first call (warm-up "
        f"and capture) {res['first_call_ms']:.0f} ms [{CARD}]")

    # step time and peak memory per remat policy
    res["remat"] = {}
    for name in ("dots", "off", "all"):
        unet.remat, unet.remat_policy = name != "off", \
            "all" if name == "off" else name
        torch.cuda.empty_cache()
        ms, peak, m = median_step_ms(trainer, batches, TRAIN_WARMUP,
                                     TRAIN_TIMED)
        res["remat"][name] = (ms, peak)
        say(f"training step remat {name:4s} (step program replays): median "
            f"{ms:.2f} ms of {TRAIN_TIMED} (after {TRAIN_WARMUP} warm-up), "
            f"peak memory {peak:.2f} GB outside the graphs' pool "
            f"({pool_gb(trainer):.2f} GB), loss {m['loss'].item():.4f} "
            f"[{CARD}]")
    unet.remat, unet.remat_policy = True, "dots"
    res["step_ms"], res["peak_gb"] = res["remat"]["dots"]

    # the K2 weight repack a fresh bf16 copy of the parameters costs
    wb = [w.detach().bfloat16() for m in unet.modules()
          if isinstance(m, ResnetBlock1D) for w in (m.conv1.weight,
                                                    m.conv2.weight)]
    wb.append(unet.conv_out.weight.detach().bfloat16())
    res["repack_ms"] = graph_ms(lambda: [fr.pack_conv_weight(w) for w in wb],
                                iters=3)
    say(f"K2 weight repack per step ({len(wb)} packs of fresh bf16 copies): "
        f"{res['repack_ms']:.3f} ms device [{CARD}]")

    # the loss on one fixed batch, fixed t and noise
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    t_fix = torch.randint(0, 1000, (TRAIN_B,), generator=gen, device=dev)
    n_fix = torch.randn(TRAIN_B, TRAIN_T, 100, generator=gen, device=dev)
    losses = [trainer.train_step(b0, t=t_fix, noise=n_fix)["loss"].item()
              for _ in range(LOSS_STEPS)]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    say(f"loss on one fixed batch over {LOSS_STEPS} steps: first five "
        f"{first:.4f}, last five {last:.4f} ({losses[0]:.4f} -> "
        f"{losses[-1]:.4f})")
    if not (np.isfinite(losses).all() and last < first):
        fail(f"training loss did not fall on a fixed batch: {losses}")
    res["loss_first"], res["loss_last"] = float(first), float(last)

    # the trainer's own loop: loader-fed, logging
    before_loop = snapshot(trainer)
    t1 = time.perf_counter()
    n0 = trainer.step
    trainer.train(num_steps=n0 + 10)
    res["loop_steps_per_s"] = 10 / (time.perf_counter() - t1)
    say(f"Trainer.train: 10 loader-fed steps at {res['loop_steps_per_s']:.2f}"
        f" steps/s (synced loader, {trainer.num_workers} workers; with its "
        f"final checkpoint) [{CARD}]")

    # every K1 / K2 geometry of the step (remat off: one call each)
    calls = PathCalls()
    unet.remat = False
    with contextlib.ExitStack() as stack:
        for p in calls.patches():
            stack.enter_context(p)
        trainer._train_step_eager(b0)
    unet.remat = True
    torch.cuda.synchronize()
    with no_tf32():
        res["geometries"] = check_train_geometries(calls, dev)

    made_by = list(steps_log)
    del trainer.train_step, trainer._train_step_eager
    states = witness_states(trainer, cfg, before_loop)
    del before_loop

    def provenance(sd):
        import hashlib
        import itertools

        from ns2vc_tpu_torch.train.trainer import step_seed

        labels = {id(b): f"serial batch {i}" for i, b in enumerate(batches)}
        sched = itertools.islice(synced_schedule(
            trainer.ds, trainer._collator, TRAIN_B, seed=cfg.train.seed),
            max(1, cfg.train.prefetch_depth) + 10)
        h = hashlib.sha256()
        for k in sorted(sd):
            h.update(k.encode())
            h.update(sd[k].float().numpy().tobytes())
        return {
            "steps": [{"step": n, "seed": step_seed(cfg.train.seed, n),
                       "batch": labels.get(i, "loader"),
                       "t_noise": f"fixed (seed {SEED + 32})" if fixed
                       else "drawn"} for n, i, fixed in made_by],
            "serial_batches": [serial_items[i * TRAIN_B:(i + 1) * TRAIN_B]
                               for i in range(len(batches))],
            "loader_schedule": [[list(geom) if geom else None,
                                 [list(e) for e in entries]]
                                for geom, entries in sched],
            "state_sha256": h.hexdigest()}
    res.update(check_grads(cfg, {k: v.detach().cpu() for k, v in
                                 trainer.model.state_dict().items()},
                           b0, dev, states, provenance))
    res["compiled"] = check_compiled_training(trainer, batches, dev)

    # checkpoint round trip and one request served from it
    path = trainer.save()
    ema = load_checkpoint(path, cfg)
    again = Trainer(cfg, logs_folder=os.path.join(tmp, "run"), device=dev)
    again.load(path=path)
    if again.step != trainer.step or any(
            not torch.equal(v, again.model.state_dict()[k])
            for k, v in trainer.model.state_dict().items()) or any(
            not torch.equal(v.cpu(), ema[k])
            for k, v in trainer.state.ema_params.items()):
        fail("checkpoint round trip: step, parameters or EMA differ")
    again.close()
    del again
    svc = Svc(path, config=cfg, vocos_params=vsd, compute_dtype="bfloat16",
              contentvec_ckpt="", device=dev)
    r = np.random.default_rng(SEED + 33)
    wav = svc.infer_from_features(
        (0.1 * r.standard_normal((T_CLIP, 256))).astype(np.float32),
        r.standard_normal((TP_REFER, 100)).astype(np.float32),
        sampling_timesteps=CLI_STEPS)
    if wav.shape != (T_CLIP * cfg.data.hop_length,) or \
            not np.isfinite(wav).all():
        fail(f"serving from the trained checkpoint: {wav.shape}")
    say(f"checkpoint {os.path.basename(path)} (step {trainer.step}) round "
        f"trip: parameters, optimizer state and EMA restored; Svc served one "
        f"{T_CLIP}-frame request from its EMA parameters, finite")
    del svc
    res["eval"] = check_compiled_eval(trainer, dev)
    check_recapture(trainer, path, b0)
    return trainer, batches, res


def training_profile(trainer, batch, step_ms, title=""):
    """One training step under torch.profiler (host and device activity):
    device time by kernel, grouped, with K1's torch backward, K2's backward
    kernels and the GroupNorm statistics attributed through
    record_function ranges (an eager step's; a replay runs no Python);
    the busy share against the unprofiled median step."""
    from unittest import mock

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    import ns2vc_tpu_torch.ops.flash_attention as fa
    import ns2vc_tpu_torch.ops.fused_resnet as fr

    def ranged(label, fn):
        def f(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return f
    ranges = {"K1 torch backward": (fa, "flash_attention_backward"),
              "K2 backward kernels": (fr, "affine_silu_conv1d_grad"),
              "GroupNorm statistics (forward)": (fr, "group_norm_affine")}
    with contextlib.ExitStack() as stack:
        for label, (mod, name) in ranges.items():
            stack.enter_context(mock.patch.object(
                mod, name, ranged(label, getattr(mod, name))))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trainer.train_step(batch)
            torch.cuda.synchronize()
    kernels, host = {}, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU:
            host[e.key] = (getattr(e, "self_cpu_time_total", 0) / 1e3,
                           e.count)
        # a range's span on the device timeline is not kernel time
        if e.device_type != DeviceType.CUDA or getattr(
                e, "is_user_annotation", False):
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        prev = kernels.get(e.key, (0.0, 0))
        kernels[e.key] = (prev[0] + dev_us / 1e3, prev[1] + e.count)
    def kernel_us(ev):   # kernels launched under a host event, nested
        return sum(k.duration for k in ev.kernels) + sum(
            kernel_us(c) for c in ev.cpu_children)
    annotated = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in ranges:
            annotated[ev.name][0] += kernel_us(ev) / 1e3
            annotated[ev.name][1] += 1
    total = sum(ms for ms, _ in kernels.values())
    if total == 0:
        say("training profile: the profiler recorded no device time")
        return {}
    groups = (("K1 forward (flash_fwd*)", ("flash_fwd",)),
              ("K2 forward (affine_silu_conv_k3*, split reduce)",
               ("affine_silu_conv", "split_k_reduce")),
              ("GroupNorm statistics (group_norm_affine_kernel; the "
               "backward's var_mean, Welford reduce)",
               ("group_norm_affine", "welford", "Welford")),
              # before cuDNN's group, whose kernel names hold "dgrad" too
              ("K2 backward (dgrad_kernel, wgrad_kernel, finalize_kernel)",
               ("::dgrad_kernel<", "::wgrad_kernel<",
                "::finalize_kernel<")),
              ("cuDNN convolutions", ("cudnn", "conv", "dgrad", "wgrad",
                                      "fprop", "implicit")),
              ("cuBLAS / CUTLASS GEMMs", ("gemm", "nvjet", "cutlass",
                                          "xmma", "sm90_", "Kernel2")),
              ("softmax", ("softmax",)),
              ("optimizer (foreach)", ("multi_tensor", "foreach")),
              ("dtype copies", ("copy",)),
              ("reductions", ("reduce",)),
              ("elementwise", ("elementwise", "vectorized")))
    grouped = defaultdict(float)
    for name, (ms, _) in kernels.items():
        label = next((lab for lab, keys in groups
                      if any(k in name for k in keys)), "other")
        grouped[label] += ms
    say(f"profile training step {title + ' ' if title else ''}(B={TRAIN_B} x "
        f"{TRAIN_T}, bf16, remat dots): {total:.1f} ms of kernel time in a step of {step_ms:.1f} ms "
        f"unprofiled: device busy {100 * total / step_ms:.0f} % [{CARD}]")
    for label, ms in sorted(grouped.items(), key=lambda kv: -kv[1]):
        say(f"  {ms:8.2f} ms {100 * ms / total:5.1f} %  {label}")
    for label, (ms, n) in annotated.items():
        say(f"  {label}: {ms:.2f} ms of kernel time over {n} calls (the "
            f"kernels launched under its range)")
    for name, (ms, n) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][0])[:10]:
        say(f"  {ms:8.2f} ms {100 * ms / total:5.1f} % x{n:<5d} {name[:90]}")
    launches = sum(n for _, n in kernels.values())
    say(f"  {launches} kernels on the card; host (profiled, self time) "
        f"{sum(ms for ms, _ in host.values()):.1f} ms, most in: " + ", ".join(
            f"{k} {ms:.1f} ms x{n}" for k, (ms, n) in sorted(
                host.items(), key=lambda kv: -kv[1][0])[:8]))
    return {"kernel_ms": total, "busy": total / step_ms,
            "kernels_launched": launches,
            "groups": dict(grouped),
            "ranges": {k: v[0] for k, v in annotated.items()}}


# -- the Trainer's step and eval programs -------------------------------------

COMPARE_STEPS = 3             # compiled vs eager from one state and seeds
BUCKETS = ((TRAIN_T, TRAIN_T), (192, 128))   # the bucketed loop's (T, Tp)
BUCKET_ROUNDS = 3             # steps per geometry, the two in turns
OPT_RTOL = 1e-6               # capturable AdamW vs eager: the optax bound


def pool_gb(trainer) -> float:
    """GB in the segments of the memory pool the trainer's graphs share."""
    import torch

    pools = {tuple(p.graph.pool()) for p in (
        *trainer._step_programs.values(), *trainer._eval_programs.values())
        if p.graph is not None}
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) in pools) / 2 ** 30


def check_eager_repeat(trainer, batches, label: str) -> dict:
    """The fault's own witness: two eager steps from one snapshot on one
    batch, under the process's default flags: the loss, its terms, the
    grad norm, every parameter, both AdamW moments and the EMA, bit for
    bit. The trainer ends at the state it started from."""
    import torch

    start = snapshot(trainer)
    runs = []
    for _ in range(2):
        restore(trainer, start)
        m = trainer._train_step_eager(batches[0])
        torch.cuda.synchronize()
        runs.append(({k: m[k].detach().float().cpu() for k in
                      ("loss", "loss_diff", "loss_f0", "grad_norm")},
                     snapshot(trainer)))
    restore(trainer, start)
    (m1, s1), (m2, s2) = runs
    bad = [f"{k} {m1[k].item()} vs {m2[k].item()}" for k in m1
           if not torch.equal(m1[k], m2[k])]
    differs = state_differs(trainer, s1, s2)
    bad += differs[:8] + ([f"... {len(differs)} tensors in all"]
                          if len(differs) > 8 else [])
    n_state = sum(len(s1[k]) for k in ("model", "opt", "ema"))
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    if bad:
        fail(f"training {label}: two eager steps from one state differ "
             f"(cuDNN deterministic, benchmark, TF32; matmul TF32: {flags}):"
             f" {bad}")
    say(f"training {label}: two eager steps from one state under the "
        f"process's default flags (cuDNN deterministic, benchmark, TF32; "
        f"matmul TF32: {flags}): loss {m1['loss'].item():.6f}, grad norm "
        f"{m1['grad_norm'].item():.6f} and {n_state} state tensors "
        f"(parameters, AdamW moments, EMA) bit for bit [{CARD}]")
    return {"bitwise": True, "state_tensors": n_state,
            "default_flags": list(flags)}


@contextlib.contextmanager
def step_draws(trainer):
    """Within the context every step body appends a dict to the yielded
    list: clones of what it draws from the trainer's step generator, t,
    noise, the first dropout mask and the F0 scale, in its
    NaturalSpeech2.forward or, in a process group, in the trainer's
    `_global_draws` and the forward after it. A capture's clones are graph
    buffers that each replay fills again."""
    from unittest import mock

    import torch

    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    gen, runs, forward = trainer.generator, [], NaturalSpeech2.forward
    drawn = {"t": (torch, "randint"), "noise": (torch, "randn"),
             "f0_scale": (torch, "rand"), "mask": (torch.Tensor, "bernoulli_")}
    # the group's draws open a step's record, its forward continues it
    opened = {"by_draws": False}

    def probe(fn, by_draws):
        def probed(*a, **kw):
            if by_draws or not opened["by_draws"]:
                runs.append({})
            opened["by_draws"] = by_draws
            cur = runs[-1]

            def rec(name, draw):
                def f(*fa, **fkw):
                    out = draw(*fa, **fkw)
                    if fkw.get("generator") is gen and name not in cur:
                        cur[name] = out.clone()
                    return out
                return f
            with contextlib.ExitStack() as stack:
                for name, (owner, attr) in drawn.items():
                    stack.enter_context(mock.patch.object(
                        owner, attr, rec(name, getattr(owner, attr))))
                return fn(*a, **kw)
        return probed
    with mock.patch.object(NaturalSpeech2, "forward", probe(forward, False)), \
            mock.patch.object(trainer, "_global_draws",
                              probe(trainer._global_draws, True)):
        yield runs


def compare_compiled_step(trainer, batches, label: str) -> dict:
    """COMPARE_STEPS steps through the step programs, captured anew (the
    first call the warm-up and the capture, the rest replays), and the
    same steps through the eager step from the same state and seeds,
    under the process's default flags: the loss and its terms, the grad
    norm and the draws (`step_draws`) of every step, and after the last
    every parameter, both AdamW moments and the EMA, bit for bit. The
    trainer ends at the state it started from, with no program."""
    import torch

    start = snapshot(trainer)
    got, ms = {}, []
    for mode in ("compiled", "eager"):
        restore(trainer, start)
        trainer.drop_programs()
        step = trainer.train_step if mode == "compiled" \
            else trainer._train_step_eager
        metrics, draws = [], []
        with step_draws(trainer) as runs:
            for i, b in enumerate(batches[:COMPARE_STEPS]):
                t0 = time.perf_counter()
                m = step(b)
                torch.cuda.synchronize()
                if mode == "compiled":
                    ms.append((time.perf_counter() - t0) * 1e3)
                # a replay refills the capture's buffers, runs[1]
                rec = runs[i] if mode == "eager" else runs[min(i, 1)]
                metrics.append({k: m[k].detach().float().cpu() for k in
                                ("loss", "loss_diff", "loss_f0",
                                 "grad_norm")})
                draws.append({k: v.cpu() for k, v in rec.items()})
        got[mode] = (metrics, draws, snapshot(trainer))
        if mode == "compiled":
            (prog,) = trainer._step_programs.values()
            capture_ms, nodes = prog.capture_ms, prog.nodes
    restore(trainer, start)
    trainer.drop_programs()
    bad = []
    for i, (a, b) in enumerate(zip(got["compiled"][0], got["eager"][0])):
        bad += [f"step {i + 1} {k} {a[k].item()} vs {b[k].item()}"
                for k in a if not torch.equal(a[k], b[k])]
    want = {"t", "noise", "mask"} | (
        {"f0_scale"} if trainer.cfg.f0_predictor.enabled else set())
    for i, (a, b) in enumerate(zip(got["compiled"][1], got["eager"][1])):
        if set(a) != want or set(b) != want:
            bad.append(f"step {i + 1} draws recorded {sorted(a)} / "
                       f"{sorted(b)}, expected {sorted(want)}")
        bad += [f"step {i + 1} draw {k}" for k in sorted(want & set(a))
                if not torch.equal(a[k], b[k])]
    differs = state_differs(trainer, got["compiled"][2], got["eager"][2])
    bad += differs[:8] + ([f"... {len(differs)} tensors in all"]
                          if len(differs) > 8 else [])
    if bad:
        fail(f"compiled training {label}: the step programs' steps differ "
             f"from the eager steps (the process's default flags): {bad}")
    n_state = sum(len(got["eager"][2][k]) for k in ("model", "opt", "ema"))
    say(f"compiled training {label}: {COMPARE_STEPS} steps through the step "
        f"program (first call {ms[0]:.0f} ms: warm-up and capture "
        f"{capture_ms:.0f} ms, {nodes} graph nodes; replays "
        f"{', '.join(f'{x:.1f}' for x in ms[1:])} ms) against the eager "
        f"step from the same state and seeds, the process's default flags:"
        f" loss, grad norm, draws {sorted(want)} and {n_state} state "
        f"tensors (parameters, AdamW moments, EMA) bit for bit [{CARD}]")
    return {"steps": COMPARE_STEPS, "bitwise": True, "draws": sorted(want),
            "first_call_ms": ms[0], "capture_ms": capture_ms, "nodes": nodes,
            "replay_wall_ms": ms[1:],
            "losses": [m["loss"].item() for m in got["eager"][0]]}


def compiled_figures(trainer, batches, label: str) -> dict:
    """The step program's figures beside the eager step's: median ms of
    TRAIN_TIMED after TRAIN_WARMUP (`median_step_ms`) in turns, compiled,
    eager, eager, compiled, and each turn's peak memory; the bytes the
    graphs' pool holds; a replay's launches and backward calls per route,
    and the graph's K1 / K2 / statistics kernel nodes (libcuda) held equal
    to the launches."""
    from unittest import mock

    import torch

    turns = {"compiled": [], "eager": []}
    for mode in ("compiled", "eager", "eager", "compiled"):
        with (contextlib.nullcontext() if mode == "compiled" else
              mock.patch.object(trainer, "train_step",
                                trainer._train_step_eager)):
            ms, peak, _ = median_step_ms(trainer, batches, TRAIN_WARMUP,
                                         TRAIN_TIMED)
        turns[mode].append((ms, peak))
    reset_launches()
    trainer.train_step(batches[0])
    torch.cuda.synchronize()
    launches, bwd = route_counts(), backward_calls()
    prog = trainer._step_programs[trainer._step_key(batches[0], None, None)]
    nodes = graph_kernels(prog.graph)
    if nodes != kernel_totals(launches):
        fail(f"compiled training {label}: the step graph's kernel nodes "
             f"{nodes}, a replay's counted launches "
             f"{kernel_totals(launches)}")
    out = {"compiled_ms": [t[0] for t in turns["compiled"]],
           "eager_ms": [t[0] for t in turns["eager"]],
           "compiled_peak_gb": max(t[1] for t in turns["compiled"]),
           "eager_peak_gb": max(t[1] for t in turns["eager"]),
           "pool_gb": pool_gb(trainer), "capture_ms": prog.capture_ms,
           "nodes": prog.nodes, "graph_kernel_nodes": nodes,
           "replay_launches": launches, "replay_backward_calls": bwd}
    say(f"compiled training {label}: median step in turns (compiled, eager, "
        f"eager, compiled) {out['compiled_ms'][0]:.2f}, "
        f"{out['eager_ms'][0]:.2f}, {out['eager_ms'][1]:.2f}, "
        f"{out['compiled_ms'][1]:.2f} ms; peak memory outside the pool "
        f"{out['compiled_peak_gb']:.2f} GB (eager {out['eager_peak_gb']:.2f}"
        f" GB), the graphs' pool {out['pool_gb']:.2f} GB; capture "
        f"{prog.capture_ms:.0f} ms, {prog.nodes} graph nodes (K1 / K2 / "
        f"statistics kernels {nodes}); a replay launches {launches}, "
        f"backward calls {bwd} [{CARD}]")
    return out


def cut_batch(batch: dict, t: int, tp: int) -> dict:
    """A device batch cut to t content and tp refer frames."""
    out = {k: (v[:, :t] if k in ("c", "spec", "f0", "uv") else
               v[:, :tp] if k == "refer" else v).contiguous()
           for k, v in batch.items()}
    out["lengths"] = batch["lengths"].clamp(max=t)
    out["refer_lengths"] = batch["refer_lengths"].clamp(max=tp)
    return out


def bucketed_loop(trainer, batches) -> dict:
    """BUCKET_ROUNDS steps at each of the two BUCKETS geometries in turns
    (A B A B ...) through the step programs, one per geometry in one
    memory pool, replayed in an order other than their capture's; each
    step held against the eager step from the same state, the process's
    default flags: loss, grad norm and the state after it, bit for bit.
    The trainer ends where it started, with no program."""
    import torch

    start = snapshot(trainer)
    bad, ms = [], []
    trainer.drop_programs()
    for r in range(BUCKET_ROUNDS):
        for j, (t, tp) in enumerate(BUCKETS):
            b = cut_batch(batches[(r + j) % len(batches)], t, tp)
            before = snapshot(trainer)
            t0 = time.perf_counter()
            m = trainer.train_step(b)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            after = snapshot(trainer)
            restore(trainer, before)
            e = trainer._train_step_eager(b)
            if not (torch.equal(m["loss"], e["loss"]) and
                    torch.equal(m["grad_norm"], e["grad_norm"])):
                bad.append(f"round {r} {t}x{tp}: loss {m['loss'].item()}"
                           f" vs {e['loss'].item()}")
            differs = state_differs(trainer, after, snapshot(trainer))
            if differs:
                bad.append(f"round {r} {t}x{tp}: {differs[:4]} "
                           f"({len(differs)} tensors)")
    progs = list(trainer._step_programs.values())
    pools = {tuple(p.graph.pool()) for p in progs}
    replays = sorted(p.replays for p in progs)
    restore(trainer, start)
    trainer.drop_programs()
    if bad or len(progs) != len(BUCKETS) or len(pools) != 1 or \
            replays != [BUCKET_ROUNDS - 1] * len(BUCKETS):
        fail(f"compiled training, bucketed loop: {bad}; {len(progs)} "
             f"programs in {len(pools)} pools, replays {replays}")
    say(f"compiled training, bucketed loop: {BUCKET_ROUNDS} steps at each of "
        f"{BUCKETS} in turns, {len(progs)} step programs in one memory pool,"
        f" every step the eager step's bit for bit (default flags); "
        f"call ms {', '.join(f'{x:.0f}' for x in ms)} (each geometry's "
        f"first: warm-up and capture) [{CARD}]")
    return {"geometries": [list(g) for g in BUCKETS],
            "rounds": BUCKET_ROUNDS, "call_ms": ms, "bitwise": not bad}


def check_capturable_adamw(dev) -> float:
    """The step programs' AdamW (capturable: step counts and bias
    corrections on the card) against the eager one over three clipped
    steps of Config()'s first parameter shapes, within OPT_RTOL (and 1e-7
    absolute). Returns the worst relative difference."""
    import torch

    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.train.trainer import (
        clip_by_global_norm, make_optimizer,
    )

    cfg = Config()
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    shapes = [(512, 256, 3), (512,), (2048, 512)]
    a = [torch.nn.Parameter(torch.randn(s, generator=g, device=dev))
         for s in shapes]
    b = [torch.nn.Parameter(p.detach().clone()) for p in a]
    oa, ob = make_optimizer(cfg, a), make_optimizer(cfg, b, capturable=True)
    worst = 0.0
    for i in range(3):
        for p, q in zip(a, b):
            p.grad = (30.0 if i == 1 else 0.01) * torch.randn(
                p.shape, generator=g, device=dev)
            q.grad = p.grad.clone()
        clip_by_global_norm([p.grad for p in a], 1.0)
        clip_by_global_norm([q.grad for q in b], 1.0)
        oa.step()
        ob.step()
        for p, q in zip(a, b):
            err = ((q - p).abs() - 1e-7).clamp(min=0) / p.abs().clamp(
                min=1e-30)
            worst = max(worst, err.max().item())
    if worst > OPT_RTOL:
        fail(f"capturable AdamW vs eager: {worst:.3g} relative (rtol "
             f"{OPT_RTOL})")
    say(f"capturable AdamW (the step programs') vs eager AdamW, 3 clipped "
        f"steps: worst {worst:.3g} relative beyond 1e-7 (rtol {OPT_RTOL}) "
        f"[{CARD}]")
    return worst


def check_compiled_eval(trainer, dev) -> dict:
    """Trainer.sample_eval through its eval program against the eager
    eval, the same item and generator seed: the first call (warm-up and
    capture) and a replay give the eager mel and waveform bit for bit; the
    ms of each."""
    from unittest import mock

    import torch

    got, ms = [], []
    for mode in ("first call", "replay", "eager"):
        with (mock.patch.object(trainer, "eval_compiled", False)
              if mode == "eager" else contextlib.nullcontext()):
            t0 = time.perf_counter()
            got.append(trainer.sample_eval(
                torch.Generator(device=dev).manual_seed(1)))
            ms.append((time.perf_counter() - t0) * 1e3)
    (key, prog), = trainer._eval_programs.items()
    same = all(np.array_equal(x[i], got[2][i]) for x in got[:2]
               for i in (0, 1))
    if any(x is None or x[1] is None or not np.isfinite(x[0]).all()
           for x in got) or not same or prog.replays != 1:
        fail(f"Trainer.sample_eval: the eval program's mel and waveform "
             f"{'equal' if same else 'differ from'} the eager eval's; "
             f"replays {prog.replays}")
    say(f"compiled eval ({key.t_pad} x {key.tr_pad} frames, UniPC 30 steps "
        f"and Vocos): first call {ms[0]:.0f} ms (warm-up and capture "
        f"{prog.capture_ms:.0f} ms, {prog.nodes} graph nodes), replay "
        f"{ms[1]:.1f} ms, eager {ms[2]:.1f} ms; mel {got[0][0].shape} and "
        f"waveform bit for bit the eager eval's [{CARD}]")
    return {"first_call_ms": ms[0], "replay_ms": ms[1], "eager_ms": ms[2],
            "capture_ms": prog.capture_ms, "nodes": prog.nodes,
            "t_pad": key.t_pad, "tr_pad": key.tr_pad, "bitwise": same}


def check_recapture(trainer, path, batch) -> None:
    """After `load` the step programs are gone and the next step captures
    anew from the restored state: it is the eager step's, bit for bit
    (the process's default flags)."""
    import torch

    trainer.train_step(batch)       # a program to drop
    trainer.load(path=path)
    held = len(trainer._step_programs)
    start = snapshot(trainer)
    m = trainer.train_step(batch)
    m = trainer.train_step(batch)   # a replay of the new capture
    compiled = snapshot(trainer)
    restore(trainer, start)
    e = trainer._train_step_eager(batch)
    e = trainer._train_step_eager(batch)
    differs = state_differs(trainer, compiled, snapshot(trainer))
    trainer.drop_programs()
    if held or differs or not torch.equal(m["loss"], e["loss"]):
        fail(f"resumed step programs: {held} programs after load; after two "
             f"steps {differs[:4]} differ from the eager steps")
    say(f"checkpoint resumed into the compiled trainer: no program after "
        f"load, captured anew, two steps the eager steps' bit for bit")


def check_compiled_training(trainer, batches, dev, label: str = "") -> dict:
    """The step programs of one trainer at 32 x 272 bf16: against the eager
    step, their figures, and (without the F0 predictor) the bucketed loop
    and the capturable AdamW; first the witness that two eager steps
    from one state agree bit for bit."""
    res = {"eager_repeat": check_eager_repeat(trainer, batches,
                                              label or "JAX case"),
           "compare": compare_compiled_step(trainer, batches, label)}
    res["figures"] = compiled_figures(trainer, batches, label)
    if not trainer.cfg.f0_predictor.enabled:
        res["bucketed"] = bucketed_loop(trainer, batches)
        res["adamw_worst_rel"] = check_capturable_adamw(dev)
    return res


# -- slice 5: the F0-predictor configuration and the other model modules ------

F0_MEL_STEPS = 4              # card vs CPU sampler steps, f32
F0_CLI_STEPS = 10             # the -a CLI run
ENC_ATOL = 2e-5               # the JAX suite's encoder bound, f32 card vs CPU
# bf16 vs f32 of the same predictor call: |p16 - p32| / |p32| over every
# frame (relative RMS). bf16 keeps 8 bits; its inputs (the bf16 encoders'
# content) already differ by ~1 %, and the 30 conv and 10 attention
# residual layers each add a relative rounding of ~2^-9 to a LayerNorm'd
# stream
PRED_BF16_RTOL = 5e-2
MODULE_C, MODULE_T, MODULE_B = 256, 400, 4
MODULE_F32_ATOL = 1e-4        # one layer, f32 (TF32 off), card vs CPU
MODULE_BF16_RTOL = 5e-2       # one layer in bf16 vs f32 CPU, of max(1, |y|)
LORA_ATOL = 1e-5              # one denoise through LoRA-merged weights
STREAM_FRAMES = 32


def f0_config():
    import dataclasses

    from ns2vc_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(cfg, f0_predictor=dataclasses.replace(
        cfg.f0_predictor, enabled=True))


def contours(n: int, t: int, seed: int):
    """n F0 contours (Hz) of t frames, a vibrato around 110-230 Hz with two
    unvoiced stretches each, and their voicing."""
    r = np.random.default_rng(seed)
    f0s, uvs = [], []
    k = np.arange(t)
    for _ in range(n):
        f0 = 110 + 120 * r.random() + 25 * np.sin(2 * np.pi * k / 80
                                                   + r.random() * 6)
        for _ in range(2):
            a = int(r.integers(0, t - 40))
            f0[a:a + int(r.integers(10, 40))] = 0.0
        f0s.append(f0.astype(np.float32))
        uvs.append((f0 > 0).astype(np.float32))
    return f0s, uvs


def plus_f0_k1(counts: dict) -> dict:
    """`counts` (route_counts() or backward_calls()) with the F0
    predictor's 10 cross-attentions added: K1's f32 route, its wgmma
    kernel."""
    return dict(counts, **{k: counts[k] + 10 for k in (
        "flash_attention_f32tc", "flash_attention_f32tc_wgmma")})


def f0_serving(svc_f, svc_off, clips, refer, f0s, uvs):
    """Svc.infer_batch (B=16, pcm16) with the predictor, auto_predict_f0
    off and on, beside the f0-off model's call, in turns (off, auto off,
    auto on, auto on, auto off, off: the host's drift falls on both
    sides), counted in each of the first calls (replays: every key has
    had its first call): auto off launches what the f0-off model launches
    (the predictor's output would go unused, so it does not run), auto on
    10 more K1 calls, on the f32 route (the predictor's f32 trunk under the
    bf16 model); then B=1, in turns."""
    import torch

    def run(svc, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = svc.infer_batch(clips, refer, sampling_timesteps=STEPS,
                               order=2, output="pcm16", **kw)
        torch.cuda.synchronize()
        return outs, (time.perf_counter() - t0) * 1e3
    n_samples = clips[0].shape[0] * svc_f.hop_size
    for auto in (False, True):      # each key's first call: the warm-up
        run(svc_f, f0s=f0s, uvs=uvs, auto_predict_f0=auto)
    calls = {"off": (svc_off, {}),
             "auto0": (svc_f, dict(f0s=f0s, uvs=uvs, auto_predict_f0=False)),
             "auto1": (svc_f, dict(f0s=f0s, uvs=uvs, auto_predict_f0=True))}
    times, counts = defaultdict(list), {}
    for name in ("off", "auto0", "auto1", "auto1", "auto0", "off"):
        reset_launches()
        outs, ms = run(calls[name][0], **calls[name][1])
        times[name].append(ms)
        counts.setdefault(name, route_counts())
        if len(outs) != B or any(o.shape != (n_samples,) or o.dtype !=
                                 np.int16 for o in outs):
            fail(f"f0 serving {name}: wrong count, shape or dtype")
    off = counts["off"]
    want = {"auto0": off, "auto1": plus_f0_k1(off)}
    for name in ("auto0", "auto1"):
        if counts[name] != want[name]:
            fail(f"f0 serving {name}: launches {counts[name]}, expected "
                 f"{want[name]} (the f0-off call's {off})")
    res = {f"{k}_ms": v for k, v in times.items()}
    res["launches"], res["launches_auto0"] = counts["auto1"], counts["auto0"]
    say(f"f0 predictor serving B={B} T={T_CLIP} Tp={TP_REFER} steps={STEPS} "
        f"bf16 pcm16, ms in turns: f0-off model {times['off']}, "
        f"auto_predict_f0 off {times['auto0']}, on {times['auto1']}; "
        f"launches {counts['auto1']} (auto off {counts['auto0']}, f0 off "
        f"{off}) [{CARD}]")
    single = defaultdict(list)
    svc_f.infer_from_features(clips[0], refer, sampling_timesteps=STEPS,
                              order=2, f0=f0s[0], uv=uvs[0],
                              auto_predict_f0=True)   # the key's first call
    for name, svc, kw in (("off", svc_off, {}),
                          ("f0", svc_f, dict(f0=f0s[0], uv=uvs[0],
                                             auto_predict_f0=True)),
                          ("f0", svc_f, dict(f0=f0s[0], uv=uvs[0],
                                             auto_predict_f0=True)),
                          ("off", svc_off, {})):
        w, ms = wall_ms(lambda: svc.infer_from_features(
            clips[0], refer, sampling_timesteps=STEPS, order=2, **kw))
        if w.shape != (n_samples,) or not np.isfinite(w).all():
            fail(f"f0 single request ({name}): {w.shape}, not finite")
        single[name].append(ms)
    res["single_ms"], res["single_off_ms"] = single["f0"], single["off"]
    say(f"f0 predictor single request B=1 steps={STEPS} bf16, ms in turns: "
        f"{single['f0']} (f0-off model {single['off']}) [{CARD}]")
    return res


def f0_card_vs_cpu(cfg_f, sd_f, dev):
    """f32, TF32 off, B=2 x 64, Tp 48: the PreModel's content (with the F0
    embedding) at ENC_ATOL and its prediction lf0_pred at ENC_ATOL of
    max(1, max|lf0_pred|) (its values reach ~2, 40 layers deep), and
    generate_mel (F0_MEL_STEPS UniPC steps from one x_T) at MODEL_ATOL, card
    (kernels) vs CPU (plain), both with the given contour; the coarse bins
    of the predicted contour; and the prediction on the card with K1
    replaced by its plain version (which part of the error is K1's)."""
    from unittest import mock

    import torch

    import ns2vc_tpu_torch.ops.attention as attention
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2, generate_mel
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention_plain
    from ns2vc_tpu_torch.ops.masking import sequence_mask
    from ns2vc_tpu_torch.ops.sequence import f0_to_coarse

    r = np.random.default_rng(SEED + 41)
    b, t, tp = 2, 64, 48
    f0s, uvs = contours(b, t, SEED + 42)
    inputs = {"c": 0.1 * r.standard_normal((b, t, 256)),
              "refer": r.standard_normal((b, tp, 100)),
              "x_T": r.standard_normal((b, t, 100)),
              "f0": np.stack(f0s), "uv": np.stack(uvs)}
    lengths, refer_lengths = torch.tensor([64, 45]), torch.tensor([48, 30])
    outs = {}
    for where in ("cuda", "cpu"):
        device = dev if where == "cuda" else torch.device("cpu")
        model = NaturalSpeech2(cfg_f)
        model.load_state_dict(sd_f)
        model.to(device).eval()
        c, refer, x_T, f0, uv = (torch.tensor(inputs[k], dtype=torch.float32,
                                              device=device)
                                 for k in ("c", "refer", "x_T", "f0", "uv"))
        ln, rl = lengths.to(device), refer_lengths.to(device)
        with torch.no_grad():
            content, _, _, pred = model.pre_model(
                c, refer, sequence_mask(ln, t), sequence_mask(rl, tp),
                f0=f0, uv=uv, auto_predict_f0=False)
        mel = generate_mel(model, c, refer, ln, rl, x_T=x_T,
                           steps=F0_MEL_STEPS, f0=f0, uv=uv,
                           auto_predict_f0=False)
        outs[where] = {"content": content.cpu(), "lf0_pred": pred.cpu(),
                       "mel": mel.cpu()}
        if where == "cuda":
            with mock.patch.object(attention, "flash_attention",
                                   flash_attention_plain), torch.no_grad():
                pred_plain = model.pre_model(
                    c, refer, sequence_mask(ln, t), sequence_mask(rl, tp),
                    f0=f0, uv=uv, auto_predict_f0=False)[3].cpu()
    errs = {k: (outs["cuda"][k] - outs["cpu"][k]).abs().max().item()
            for k in outs["cpu"]}
    errs["lf0_pred_plain_k1"] = (pred_plain
                                 - outs["cpu"]["lf0_pred"]).abs().max().item()
    pred_scale = max(1.0, outs["cpu"]["lf0_pred"].abs().max().item())
    bins = (f0_to_coarse(700.0 * (10.0 ** (outs[w]["lf0_pred"][..., 0]
                                           * 500.0 / 2595.0) - 1.0))
            for w in ("cuda", "cpu"))
    same_bins = (next(bins) == next(bins)).float().mean().item()
    say(f"f0 predictor f32 card vs CPU (B=2 T=64, TF32 off): content "
        f"{errs['content']:.3e} (tol {ENC_ATOL:g}), lf0_pred "
        f"{errs['lf0_pred']:.3e} (tol {ENC_ATOL:g} x max(1, max|lf0_pred|)="
        f"{pred_scale:.3g}; with K1's plain version on the card "
        f"{errs['lf0_pred_plain_k1']:.3e}), mel after {F0_MEL_STEPS} UniPC "
        f"steps {errs['mel']:.3e} (tol {MODEL_ATOL:g}); predicted coarse F0 "
        f"bins equal on {100 * same_bins:.1f} % of frames")
    for key, tol in (("content", ENC_ATOL),
                     ("lf0_pred", ENC_ATOL * pred_scale),
                     ("mel", MODEL_ATOL)):
        if not all(torch.isfinite(outs[w][key]).all() for w in outs) or \
                not errs[key] <= tol:
            fail(f"f0 predictor card vs CPU: {key} error {errs[key]} > {tol}")
    return errs


def f0_bf16_vs_f32(cfg_f, sd_f, dev):
    """The predictor's output at the serving shapes (B=16 x 448 over a
    320-frame prompt) in bf16 against the same call in f32 on the card."""
    import torch

    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.ops.masking import sequence_mask

    r = np.random.default_rng(SEED + 43)
    f0s, uvs = contours(B, T_PAD, SEED + 44)
    c = torch.tensor(0.1 * r.standard_normal((B, T_PAD, 256)),
                     dtype=torch.float32, device=dev)
    refer = torch.tensor(r.standard_normal((B, TP_PAD, 100)),
                         dtype=torch.float32, device=dev)
    f0 = torch.tensor(np.stack(f0s), device=dev)
    uv = torch.tensor(np.stack(uvs), device=dev)
    cm = sequence_mask(torch.full((B,), T_CLIP, device=dev), T_PAD)
    rm = sequence_mask(torch.full((B,), TP_REFER, device=dev), TP_PAD)
    outs = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = NaturalSpeech2(cfg_f)
        model.load_state_dict(sd_f)
        model.to(dev, dtype).eval()
        with no_tf32(), torch.no_grad():
            content, _, _, pred = model.pre_model(
                c.to(dtype), refer.to(dtype), cm, rm, f0=f0, uv=uv,
                auto_predict_f0=True)
        outs[dtype] = (content.float(), pred.float())
        del model
    (c32, p32), (c16, p16) = outs[torch.float32], outs[torch.bfloat16]
    rel = ((p16 - p32).norm() / p32.norm()).item()
    err = (p16 - p32).abs().max().item()
    scale = p32.abs().max().item()
    say(f"f0 predictor bf16 vs f32 on the card (B={B} T={T_PAD} Tp={TP_PAD}):"
        f" lf0_pred relative RMS error {rel:.3e} (tol {PRED_BF16_RTOL:g}; "
        f"4.28e-2 with the predictor's trunk in bf16), "
        f"max_abs_err {err:.3e} at max|f32| {scale:.3f}; content max_abs_err "
        f"{(c16 - c32).abs().max().item():.3e}")
    if not rel <= PRED_BF16_RTOL:
        fail(f"f0 predictor bf16 vs f32: relative RMS {rel} > "
             f"{PRED_BF16_RTOL}")
    return {"pred_bf16_rel_rms": rel, "pred_bf16_max_abs_err": err,
            "pred_scale": scale}


def f0_k1_geometry(dev):
    """K1 at the predictor's cross-attention: q of B=16 x 448 frames, k/v
    of the 320-frame prompt bucket with 272 valid keys, 8 heads of 32, each
    a head view of its (B, T, 256) projection; bf16 and f32."""
    import torch

    from ns2vc_tpu_torch.ops.attention import split_heads

    g = torch.Generator(device=dev).manual_seed(SEED + 45)
    bias = torch.zeros(B, TP_PAD, device=dev)
    bias[:, TP_REFER:] = -1e4
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (split_heads(torch.randn(B, n, 256, generator=g,
                                           device=dev).to(dtype), 8)
                   for n in (T_PAD, TP_PAD, TP_PAD))
        r = k1_case(q, k, v, bias)
        say(f"K1 f0_predictor_cross {str(dtype)[6:]:8s} B={B} H=8 Tq={T_PAD} "
            f"Tk={TP_PAD} D=32 {r['route']} max_abs_err={r['err']:.3e} (tol "
            f"{r['tol']:g}) kernel_ms={r['ms']:.4f} plain_ms={r['plain']:.4f} "
            f"sdpa_ms={r['lib']:.4f} bound_ms={r['bound']:.5f} "
            f"({r['bound_by']}) [{CARD}]")
        if not r["err"] <= r["tol"]:
            fail(f"K1 f0 predictor geometry {dtype}: {r['err']} > {r['tol']}")
        out[r["route"]] = r
    return out


def _f0_cli(cfg_f, sd_f, vsd, cv_sd, crepe_sd):
    """The CLI with -a on a checkpoint that has the predictor (-c its
    config): a finite waveform of the source's length; the launches."""
    from unittest import mock

    import ns2vc_tpu_torch.infer.svc as svc_mod
    from ns2vc_tpu_torch.audio.host import read_wav, write_wav
    from ns2vc_tpu_torch.config import save_config
    from ns2vc_tpu_torch.features.contentvec import ContentVec
    from ns2vc_tpu_torch.infer.cli import main as cli_main

    sr = 44100
    src = np.concatenate([tone(int(5.0 * sr), sr, SEED + 46, 190.0),
                          np.zeros(sr, np.float32),
                          tone(int(3.0 * sr), sr, SEED + 47, 230.0)])
    want_len = -(-len(src) * cfg_f.data.sampling_rate // sr)
    calls = defaultdict(int)

    def counted(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_checkpoints(tmp, sd_f, vsd, cv_sd, crepe_sd)
        save_config(cfg_f, os.path.join(tmp, "config.json"))
        raw = os.path.join(tmp, "raw")
        os.makedirs(raw)
        write_wav(os.path.join(raw, "src.wav"), src, sr)
        write_wav(os.path.join(raw, "ref.wav"),
                  tone(3 * sr, sr, SEED + 48, 150.0), sr)
        argv = ["-m", paths["model"], "-c", os.path.join(tmp, "config.json"),
                "-n", "src.wav", "-r", "ref.wav", "-a",
                "--contentvec_ckpt", paths["cv"], "--vocos_ckpt",
                paths["vocos"], "--raw_dir", raw, "--out_dir",
                os.path.join(tmp, "out"), "--compute_dtype", "bfloat16",
                "--sampling_timesteps", str(F0_CLI_STEPS)]
        reset_launches()
        with mock.patch.object(ContentVec, "forward", counted(
                "contentvec", ContentVec.forward)), \
                mock.patch.object(svc_mod.Svc, "_run", counted(
                    "batches", svc_mod.Svc._run)), \
                mock.patch.object(svc_mod.Svc, "_capture", counted(
                    "programs", svc_mod.Svc._capture)):
            _, ms = wall_ms(lambda: cli_main(argv))
        counts = route_counts()
        wav, out_sr = read_wav(os.path.join(tmp, "out", "src_auto_ref.wav"))
    # each batch one replay, each program's first call one warm-up too
    runs = calls["batches"] + calls["programs"]
    want = {"flash_attention_f32tc": 12 * calls["contentvec"] + 10 * runs,
            "flash_attention_f32tc_q1": 0,
            "flash_attention_tc": runs * (14 + 32 * F0_CLI_STEPS),
            "flash_attention_f32tc_narrow": 0,
            "flash_attention_tc_narrow": 0, "flash_attention_tc_q1": 2 * runs,
            "affine_silu_conv1d_f32tc": 0, "affine_silu_conv1d_f32tc_elem": 0,
            "affine_silu_conv1d_tc": runs * 45 * F0_CLI_STEPS,
            "affine_silu_conv1d_tc_elem": 0,
            "group_norm_affine": runs * 45 * F0_CLI_STEPS}
    if out_sr != cfg_f.data.sampling_rate or not np.isfinite(wav).all() or \
            abs(len(wav) - want_len) > cfg_f.data.hop_length or \
            route_totals(counts) != want:
        fail(f"f0 CLI -a: {len(wav)} samples at {out_sr} Hz (expected "
             f"{want_len}), launches {counts} (expected {want})")
    say(f"wav in -> wav out, CLI -a (F0 predictor), unipc {F0_CLI_STEPS} "
        f"steps bf16: 9.0 s source -> {len(wav)} samples at 24 kHz, finite; "
        f"{ms:.0f} ms; {dict(calls)}; launches {counts} [{CARD}]")
    return ms


def check_f0_grads(cfg_f, sd_f, batch, dev):
    """One step's f32 gradients at full width, B=2 x 272, dropout off,
    fixed t, noise and F0 scale: card (f32 kernels, TF32 off) vs CPU
    (plain) for the predictor's and the F0 embedding's parameters, each
    within GRAD_RTOL of max(1e-3, max|g_cpu|). The CPU run takes the card
    run's ReLU gates (`relu_gates`), so both differentiate the same
    piecewise-linear function; the pre-activations whose gate differs on
    the CPU are counted and reported. The F0 prenet's LayerNorm scale is
    left out and reported: its gradient is zero in exact arithmetic (the
    normalised one-channel input is 0), and the CPU's f32 LayerNorm leaves
    up to ~4e-6 of noise there (scripts/torch_f0_grad_precision.py)."""
    import dataclasses

    import torch

    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    cfg0 = dataclasses.replace(
        cfg_f, phoneme_encoder=dataclasses.replace(cfg_f.phoneme_encoder,
                                                   p_dropout=0.0),
        prompt_encoder=dataclasses.replace(cfg_f.prompt_encoder,
                                           p_dropout=0.0),
        f0_predictor=dataclasses.replace(cfg_f.f0_predictor, p_dropout=0.0))
    gen = torch.Generator().manual_seed(SEED + 49)
    t = torch.randint(0, 1000, (2,), generator=gen)
    noise = torch.randn(2, TRAIN_T, 100, generator=gen)
    factor = 0.8 + 0.4 * torch.rand(2, generator=gen)
    small = {k: v[:2].float() if v.is_floating_point() else v[:2]
             for k, v in batch.items()}

    def grads(device):
        model = NaturalSpeech2(cfg0, remat=True, remat_policy="dots")
        model.load_state_dict(sd_f)
        model.to(device).train()
        b = {k: v.to(device) for k, v in small.items()}
        loss, aux = model(b, t=t.to(device), noise=noise.to(device),
                          f0_factor=factor.to(device))
        loss.backward()
        return aux["loss_f0"].item(), {
            n: p.grad.detach().cpu().double()
            for n, p in model.named_parameters()
            if n.startswith(("pre_model.f0_predictor.", "pre_model.f0_emb."))}
    gates, replay = [], []
    with no_tf32():
        with relu_gates(gates):
            (lf_card, g_card), ms = wall_ms(lambda: grads(dev))
        with relu_gates(gates, replay):
            lf_cpu, g_cpu = grads(torch.device("cpu"))
    noise = (g_card.pop(PRENET_LN_SCALE).abs().max().item(),
             g_cpu.pop(PRENET_LN_SCALE).abs().max().item())
    worst, worst_name = 0.0, None
    for name, want in g_cpu.items():
        err = (g_card[name] - want).abs().max().item() / max(
            1e-3, want.abs().max().item())
        if not np.isfinite(err) or err > GRAD_RTOL:
            fail(f"f0 card vs CPU gradient {name}: {err:.3e} of max(1e-3, "
                 f"max|g|) > {GRAD_RTOL}")
        if err >= worst:
            worst, worst_name = err, name
    say(f"f0 predictor gradients at full width, f32 (TF32 off), B=2 x "
        f"{TRAIN_T}, card vs CPU on the card's ReLU gates: loss_f0 "
        f"{lf_card:.6f} vs {lf_cpu:.6f}; {len(g_cpu)} tensors of the "
        f"predictor and f0_emb, worst {worst_name} {worst:.3e} of max(1e-3, "
        f"max|g|) (tol {GRAD_RTOL:g}); gates the CPU's own pre-activations "
        f"would set otherwise: {sum(replay)} of "
        f"{sum(g.numel() for g in gates)} in {len(gates)} relu calls; left "
        f"out, zero in exact arithmetic: f0_prenet.LayerNorm_0.weight, max|g| "
        f"card {noise[0]:.2e}, CPU {noise[1]:.2e}; card step {ms:.0f} ms")
    return worst


def f0_training(off, trainer_off, batches_off, vsd, dev, tmp):
    """Config() with the predictor through the Trainer at 32 x 272, bf16,
    remat dots: card vs CPU gradients at the initial weights, launches and
    backward calls per step (+10 K1 each against
    the f0-off step's counts `off`), step time and peak memory in turns
    with the f0-off trainer (off, f0, off: both trainers stay resident, so
    each peak includes the other's parameters and optimizer state),
    loss_f0 over LOSS_STEPS steps on one fixed batch, and a checkpoint
    served by Svc. Returns the results, the
    trainer and its batches (for the profile at the end)."""
    import dataclasses

    import torch

    from ns2vc_tpu_torch.infer.svc import Svc
    from ns2vc_tpu_torch.train.trainer import Trainer

    # a serial loader: the same batches in every run (spawned workers hand
    # them out in the order they finish); the steps here are timed on
    # device-resident batches
    cfg = dataclasses.replace(
        trainer_off.cfg,
        train=dataclasses.replace(trainer_off.cfg.train, num_workers=0),
        f0_predictor=dataclasses.replace(trainer_off.cfg.f0_predictor,
                                         enabled=True))
    res = {}
    trainer = Trainer(cfg, logs_folder=os.path.join(tmp, "run_f0"),
                      vocos_params=vsd, device=dev)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    loader = trainer.loader()
    batches = [trainer.device_batch(next(loader)) for _ in range(4)]
    b0 = batches[0]
    if "f0" not in b0 or tuple(b0["f0"].shape) != (TRAIN_B, TRAIN_T):
        fail(f"f0 training batch: {sorted(b0)}")
    res["grad_f32_worst"] = check_f0_grads(
        cfg, {k: v.detach().cpu() for k, v in
              trainer.model.state_dict().items()}, b0, dev)
    trainer.train_step(b0)
    torch.cuda.synchronize()
    reset_launches()
    trainer.train_step(batches[1])
    torch.cuda.synchronize()
    launches, bwd = route_counts(), backward_calls()
    # the predictor's 10 cross-attentions take K1's f32 route (its f32
    # trunk under the bf16 step), each once, not recomputed
    want = plus_f0_k1(off["launches"])
    want_bwd = plus_f0_k1(off["backward"])
    if launches != want or bwd != want_bwd or \
            grad_launches() != off["grad_launches"]:
        fail(f"f0 training step launches {launches} (expected {want}), "
             f"backward calls {bwd} (expected {want_bwd}), K2's backward "
             f"kernels {grad_launches()} (expected {off['grad_launches']})")
    res["launches"], res["backward"] = launches, bwd
    res["compiled"] = check_compiled_training(trainer, batches, dev,
                                              "with the F0 predictor")
    turns = []
    for tr, bs in ((trainer_off, batches_off), (trainer, batches),
                   (trainer_off, batches_off)):
        torch.cuda.empty_cache()
        resident = torch.cuda.memory_allocated() / 2 ** 30
        ms, peak, m_ = median_step_ms(tr, bs, TRAIN_WARMUP, TRAIN_TIMED)
        turns.append((ms, peak, resident))
        if tr is trainer:
            m = m_
    (off1, _, _), (ms, peak, resident), (off2, off_peak, off_res) = turns
    res.update(step_ms=ms, peak_gb=peak, resident_gb=resident,
               off_step_ms=[off1, off2], off_peak_gb=off_peak,
               off_resident_gb=off_res)
    say(f"f0 predictor training: Config() + predictor, {n_params / 1e6:.1f} "
        f"M parameters, {TRAIN_B} x {TRAIN_T} bf16 remat dots, in turns with "
        f"the f0-off trainer: median {ms:.2f} ms (f0 off {off1:.2f} before, "
        f"{off2:.2f} after), peak {peak:.2f} GB over {resident:.2f} GB "
        f"resident (f0 off {off_peak:.2f} over {off_res:.2f}); launches "
        f"{launches}, backward calls {bwd}; loss_diff "
        f"{m['loss_diff'].item():.4f} loss_f0 {m['loss_f0'].item():.4f} "
        f"[{CARD}]")
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    t_fix = torch.randint(0, 1000, (TRAIN_B,), generator=gen, device=dev)
    n_fix = torch.randn(TRAIN_B, TRAIN_T, 100, generator=gen, device=dev)
    losses = [trainer.train_step(b0, t=t_fix, noise=n_fix)["loss_f0"].item()
              for _ in range(LOSS_STEPS)]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    say(f"loss_f0 on one fixed batch over {LOSS_STEPS} steps: first five "
        f"{first:.4f}, last five {last:.4f}")
    if not (np.isfinite(losses).all() and last < first):
        fail(f"loss_f0 did not fall on a fixed batch: {losses}")
    res["loss_f0_first"], res["loss_f0_last"] = float(first), float(last)
    path = trainer.save()
    svc = Svc(path, config=cfg, vocos_params=vsd, compute_dtype="bfloat16",
              contentvec_ckpt="", device=dev)
    r = np.random.default_rng(SEED + 51)
    f0s, uvs = contours(1, T_CLIP, SEED + 52)
    wav = svc.infer_from_features(
        (0.1 * r.standard_normal((T_CLIP, 256))).astype(np.float32),
        r.standard_normal((TP_REFER, 100)).astype(np.float32),
        sampling_timesteps=CLI_STEPS, f0=f0s[0], uv=uvs[0],
        auto_predict_f0=True)
    if wav.shape != (T_CLIP * cfg.data.hop_length,) or \
            not np.isfinite(wav).all():
        fail(f"serving the f0 checkpoint: {wav.shape}")
    say(f"f0 checkpoint {os.path.basename(path)}: Svc served one {T_CLIP}-"
        f"frame request with auto_predict_f0 from its EMA parameters, finite")
    return res, trainer, batches


def check_f0_predictor(sd_off_svc, clips, refer, vsd, cv_sd, crepe_sd,
                       train_off, trainer_off, batches_off, dev, tmp):
    """The F0-predictor configuration at full width (seed-0 weights):
    serving, card vs CPU, bf16 vs f32, K1 at its geometry, the CLI with -a,
    and training. Returns the results and the f0 trainer with its
    batches."""
    import torch

    from ns2vc_tpu_torch.convert import init_params
    from ns2vc_tpu_torch.infer.svc import Svc

    cfg_f = f0_config()
    sd_f = init_params(cfg_f, torch.Generator().manual_seed(SEED))
    n_pred = sum(v.numel() for k, v in sd_f.items()
                 if k.startswith(("pre_model.f0_predictor.",
                                  "pre_model.f0_emb.")))
    say(f"F0-predictor configuration: {n_pred / 1e6:.2f} M parameters in the "
        f"predictor and F0 embedding, "
        f"{sum(v.numel() for v in sd_f.values()) / 1e6:.1f} M in all")
    svc_f = Svc(config=cfg_f, params=sd_f, vocos_params=vsd,
                compute_dtype="bfloat16", device=dev)
    f0s, uvs = contours(B, T_CLIP, SEED + 40)
    res = {"serving": f0_serving(svc_f, sd_off_svc, clips, refer, f0s, uvs)}
    del svc_f
    torch.cuda.empty_cache()
    res["cli_ms"] = _f0_cli(cfg_f, sd_f, vsd, cv_sd, crepe_sd)
    with no_tf32():
        res["card_vs_cpu"] = f0_card_vs_cpu(cfg_f, sd_f, dev)
    res.update(f0_bf16_vs_f32(cfg_f, sd_f, dev))
    with no_tf32():
        res["k1"] = f0_k1_geometry(dev)
    res["training"], trainer, batches = f0_training(
        train_off, trainer_off, batches_off, vsd, dev, tmp)
    return res, trainer, batches


def module_routes() -> dict:
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention

    return dict(route_counts(), plain=flash_attention.route_launches["plain"])


def check_op_registry(dev):
    """Ids 1-15 (13 also with its Gaussian bias) at C=256, T=400, B=4 with
    padded items: card f32 (TF32 off) and bf16 against the CPU in f32, the
    route of each call counted; K1 at ids 14/15's D = 128 timed."""
    import torch

    from ns2vc_tpu_torch.convert import init_module_
    from ns2vc_tpu_torch.models.op_registry import OPERATIONS_ENCODER
    from ns2vc_tpu_torch.ops.attention import split_heads
    from ns2vc_tpu_torch.ops.flash_attention import flash_attention

    r = np.random.default_rng(SEED + 60)
    x = torch.tensor(r.standard_normal((MODULE_B, MODULE_T, MODULE_C)),
                     dtype=torch.float32)
    lengths = torch.tensor([MODULE_T - (i % 2) * MODULE_T // 4
                            for i in range(MODULE_B)])
    mask = torch.arange(MODULE_T)[None] < lengths[:, None]
    cases = [(i, {}) for i in range(1, 16)] + [(13, {"g_bias": True,
                                                     "tao": 3.0})]
    attention_ids = {8: 8, 9: 4, 10: 8, 14: 2, 15: 2}   # id -> heads
    worst = {}
    for op_id, kw in cases:
        name = f"{op_id}{'+gaus' if kw else ''}"
        layer = init_module_(OPERATIONS_ENCODER[op_id](MODULE_C, 0.0, **kw),
                             torch.Generator().manual_seed(op_id)).eval()
        with torch.no_grad():
            want = layer(x, mask)
        parts = []
        for dtype in (torch.float32, torch.bfloat16):
            layer.to(dev, dtype)
            reset_launches()
            with no_tf32(), torch.no_grad():
                got = layer(x.to(dev, dtype), mask.to(dev)).float().cpu()
            torch.cuda.synchronize()
            routes = {k: v for k, v in route_totals(module_routes()).items()
                      if v}
            err = (got - want).abs().max().item()
            tol = MODULE_F32_ATOL if dtype == torch.float32 else \
                MODULE_BF16_RTOL * max(1.0, want.abs().max().item())
            if op_id in attention_ids:
                want_routes = {k1_route(dtype): 1}
            elif op_id in (11, 13):
                want_routes = {"plain": 1}
            else:
                want_routes = {}
            if not torch.isfinite(got).all() or not err <= tol or \
                    routes != want_routes:
                fail(f"op {name} {dtype}: error {err} (tol {tol}), routes "
                     f"{routes} (expected {want_routes})")
            worst[(name, str(dtype)[6:])] = err
            parts.append(f"{str(dtype)[6:]} err {err:.2e} (tol {tol:.2g}) "
                         f"routes {routes or 'none'}")
        say(f"op registry id {name:7s} C={MODULE_C} T={MODULE_T} B={MODULE_B}"
            f": " + "; ".join(parts))
    # K1 at ids 14 / 15: two heads of 128, self-attention, key padding
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    bias = torch.where(mask, 0.0, -1e4).to(dev)
    d128 = {}
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn(MODULE_B, MODULE_T, 3 * MODULE_C, generator=g,
                          device=dev).to(dtype)
        q, k, v = (split_heads(t_, 2) for t_ in qkv.split(MODULE_C, dim=-1))
        reset_launches()
        flash_attention(q, k, v, bias)
        routes = {k: n for k, n in route_totals(route_counts()).items() if n}
        want_routes = ({"flash_attention_tc": 1} if dtype == torch.bfloat16
                       else {"flash_attention_f32tc": 1})
        if routes != want_routes:
            fail(f"K1 D=128 {dtype}: routes {routes}, expected {want_routes}")
        with no_tf32():
            rr = k1_case(q, k, v, bias)
        say(f"K1 op_registry_d128 {str(dtype)[6:]:8s} B={MODULE_B} H=2 "
            f"Tq=Tk={MODULE_T} D=128 {rr['route']} max_abs_err="
            f"{rr['err']:.3e} (tol {rr['tol']:g}) kernel_ms={rr['ms']:.4f} "
            f"plain_ms={rr['plain']:.4f} sdpa_ms={rr['lib']:.4f} bound_ms="
            f"{rr['bound']:.5f} ({rr['bound_by']}) [{CARD}]")
        if not rr["err"] <= rr["tol"]:
            fail(f"K1 D=128 {dtype}: {rr['err']} > {rr['tol']}")
        d128[str(dtype)[6:]] = rr
    return worst, d128


def check_cfg_sample(cfg, sd, dev):
    """A classifier-free-guidance UniPC sample, B=16 x 400, 10 steps, bf16:
    model_wrapper over the denoiser with the encoded prompt as the
    condition and zeros as the unconditional one, one UNet call per step on
    the doubled batch (no precomputed K/V: the condition changes)."""
    import torch

    from ns2vc_tpu_torch.diffusion.samplers import unipc_sample
    from ns2vc_tpu_torch.diffusion.wrappers import model_wrapper
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.ops.masking import sequence_mask

    steps = 10
    model = NaturalSpeech2(cfg)
    model.load_state_dict(sd)
    model.to(dev, torch.bfloat16).eval()
    r = np.random.default_rng(SEED + 62)
    c = torch.tensor(0.1 * r.standard_normal((B, T_PAD, 256)),
                     dtype=torch.bfloat16, device=dev)
    refer = torch.tensor(r.standard_normal((B, TP_PAD, 100)),
                         dtype=torch.bfloat16, device=dev)
    cm = sequence_mask(torch.full((B,), T_CLIP, device=dev), T_PAD)
    rm = sequence_mask(torch.full((B,), TP_REFER, device=dev), TP_PAD)
    with torch.no_grad():
        content, prompt = model.encode(c, refer, cm, rm)

    def net(x, t, cond):
        n = x.shape[0] // content.shape[0]
        return model.denoise(x, content.repeat(n, 1, 1), cond,
                             rm.repeat(n, 1), t)
    x0_fn = model_wrapper(net, model.schedule, model_type="x_start",
                          guidance_type="classifier-free", condition=prompt,
                          unconditional_condition=torch.zeros_like(prompt),
                          guidance_scale=2.0)
    x_T = torch.randn(B, T_PAD, 100, device=dev, dtype=torch.bfloat16)
    reset_launches()
    with torch.no_grad():
        mel, ms = wall_ms(lambda: unipc_sample(x0_fn, x_T, model.schedule,
                                               steps))
    counts = route_counts()
    # per UNet call: 32 attentions + the pooled add_embedding (D = 4)
    want = {"flash_attention_f32tc": 0, "flash_attention_f32tc_q1": 0,
            "flash_attention_tc": steps * 33,
            "flash_attention_f32tc_narrow": 0,
            "flash_attention_tc_narrow": 0,
            "flash_attention_tc_q1": steps, "affine_silu_conv1d_f32tc": 0,
            "affine_silu_conv1d_f32tc_elem": 0,
            "affine_silu_conv1d_tc": steps * 45, "affine_silu_conv1d_tc_elem": 0,
            "group_norm_affine": steps * 45}
    if not torch.isfinite(mel.float()).all() or route_totals(counts) != want:
        fail(f"CFG sample: finite {torch.isfinite(mel.float()).all()}, "
             f"launches {counts} (expected {want})")
    say(f"classifier-free guidance UniPC sample B={B} T={T_PAD} steps={steps}"
        f" bf16 (scale 2, doubled batch {2 * B}): finite, {ms:.1f} ms; "
        f"launches {counts} [{CARD}]")
    return ms


def check_lora_merge(cfg, sd, dev):
    """LoRA (rank 4, nonzero up factors) merged by apply_lora against the
    same deltas merged by hand in f64: one f32 denoise on the card."""
    import torch

    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.models.lora import (
        apply_lora, count_lora_params, init_lora,
    )
    from ns2vc_tpu_torch.ops.masking import sequence_mask

    g = torch.Generator().manual_seed(SEED + 63)
    lora = init_lora(sd, g, rank=4)
    for ab in lora.values():
        ab["up"] = 0.05 * torch.randn(ab["up"].shape, generator=g)
    merged = apply_lora(sd, lora)
    hand = {k: v.double().clone() for k, v in sd.items()}
    for name, ab in lora.items():
        delta = (ab["down"].double() @ ab["up"].double()).T
        if name in hand:
            hand[name] += delta
            continue
        mod, part, _ = name.rsplit(".", 2)
        i, rows = ("to_q", "to_k", "to_v").index(part), delta.shape[0]
        hand[f"{mod}.to_qkv.weight"][i * rows:(i + 1) * rows] += delta
    hand = {k: v.float() for k, v in hand.items()}
    r = np.random.default_rng(SEED + 64)
    b, t, tp = 2, 64, 48
    c, refer, x = (torch.tensor(r.standard_normal(s), dtype=torch.float32,
                                device=dev)
                   for s in ((b, t, 256), (b, tp, 100), (b, t, 100)))
    rm = sequence_mask(torch.tensor([48, 30], device=dev), tp)
    cm = sequence_mask(torch.tensor([64, 50], device=dev), t)
    ts = torch.tensor([500.0, 20.0], device=dev)
    outs = {}
    for name, weights in (("merged", merged), ("hand", hand), ("base", sd)):
        model = NaturalSpeech2(cfg)
        model.load_state_dict(weights)
        model.to(dev).eval()
        with no_tf32(), torch.no_grad():
            content, prompt = model.encode(c, refer, cm, rm)
            outs[name] = model.denoise(x, content, prompt, rm, ts).cpu()
    err = (outs["merged"] - outs["hand"]).abs().max().item()
    moved = (outs["merged"] - outs["base"]).abs().max().item()
    say(f"LoRA rank 4 over {len(lora)} weights ({count_lora_params(lora)} "
        f"parameters): merged vs merged by hand, one f32 denoise on the card,"
        f" max_abs_err {err:.3e} (tol {LORA_ATOL:g}); the adapter moves the "
        f"output by {moved:.3e}")
    if not err <= LORA_ATOL or not moved > 100 * LORA_ATOL:
        fail(f"LoRA merge: {err} against the hand merge, moved {moved}")
    return err


def check_streaming(dev):
    """STREAM_FRAMES frames of streaming attention (K1, the fill index as
    a key bias) against the causal full attention (the plain route), and
    ConvFFN.step against the LEFT-padded layer, f32 on the card."""
    import torch

    from ns2vc_tpu_torch.convert import init_module_
    from ns2vc_tpu_torch.models.encoders import ConvFFN
    from ns2vc_tpu_torch.ops.attention import (
        init_kv_cache, multihead_attention, streaming_attention,
    )

    g = torch.Generator(device=dev).manual_seed(SEED + 65)
    n, heads = STREAM_FRAMES, 8
    q, k, v = (torch.randn(MODULE_B, n, MODULE_C, generator=g, device=dev)
               for _ in range(3))
    causal = torch.triu(torch.full((n, n), -1e4, device=dev), 1)[None, None]
    cache = init_kv_cache(MODULE_B, heads, MODULE_C // heads, n, device=dev)
    reset_launches()
    with no_tf32(), torch.no_grad():
        outs = []
        for i in range(n):
            o, cache = streaming_attention(q[:, i:i + 1], k[:, i:i + 1],
                                           v[:, i:i + 1], cache, heads)
            outs.append(o)
        stream_counts = module_routes()
        full = multihead_attention(q, k, v, heads, bias=causal)
        att_err = (torch.cat(outs, 1) - full).abs().max().item()
        ffn = init_module_(ConvFFN(MODULE_C, 9, padding="LEFT"),
                           torch.Generator().manual_seed(SEED + 66))
        ffn.to(dev).eval()
        buf = ffn.init_buffer(MODULE_B, device=dev)
        ys = []
        for i in range(n):
            y, buf = ffn.step(q[:, i:i + 1], buf)
            ys.append(y)
        ffn_err = (torch.cat(ys, 1) - ffn(q)).abs().max().item()
    say(f"streaming: {n} frames of streaming_attention (B={MODULE_B}, "
        f"{heads} heads, C={MODULE_C}) vs causal full attention "
        f"{att_err:.3e}, ConvFFN.step vs the LEFT-padded layer {ffn_err:.3e}"
        f" (tol {ENC_ATOL:g}); streaming launches {stream_counts}")
    if not (att_err <= ENC_ATOL and ffn_err <= ENC_ATOL) or \
            stream_counts["flash_attention_f32tc"] != n or stream_counts["plain"]:
        fail(f"streaming: attention {att_err}, ConvFFN {ffn_err}, launches "
             f"{stream_counts}")
    return att_err, ffn_err


def check_model_modules(cfg, sd, dev):
    res = {}
    res["op_registry_worst"], res["d128"] = check_op_registry(dev)
    res["cfg_sample_ms"] = check_cfg_sample(cfg, sd, dev)
    res["lora_err"] = check_lora_merge(cfg, sd, dev)
    res["stream_errs"] = check_streaming(dev)
    return res


# -- slice 7: the NSF-HiFiGAN vocoder ----------------------------------------

NSF_SECONDS = 10.0           # the reconstruct clip and the timed generator
NSF_IN_SR = 48000            # the clip's rate: the resampler runs
NSF_BATCHES = (1, 4)         # the generator alone, B x 10 s
NSF_CHECK_SECONDS = 2.0      # full-width generator, card vs CPU
NSF_WAV_ATOL = 1e-4          # f32, TF32 off: cuDNN vs CPU convolutions
                             # summed in other orders over 5 stages
NSF_DISC_B, NSF_DISC_T = 2, 8192
NSF_DISC_RTOL = 1e-4         # of each tensor's max |CPU|, and each loss
PEAK_F32_CORES = 67e12       # the f32 CUDA cores (no TF32)


def nsf_config() -> dict:
    """The reference `config.json` of the community 44.1 kHz NSF-HiFiGAN,
    the JAX generator's defaults (128 mels, 512 channels, rates (8, 8, 2,
    2, 2), ResBlock1 (3, 7, 11) x (1, 3, 5))."""
    return {"sampling_rate": 44100, "num_mels": 128, "n_fft": 2048,
            "hop_size": 512, "win_size": 2048, "fmin": 40, "fmax": 16000,
            "upsample_rates": [8, 8, 2, 2, 2],
            "upsample_kernel_sizes": [16, 16, 4, 4, 4],
            "upsample_initial_channel": 512, "resblock": "1",
            "resblock_kernel_sizes": [3, 7, 11],
            "resblock_dilation_sizes": [[1, 3, 5]] * 3}


def nsf_work(gen, mel, f0) -> tuple[float, float]:
    """FLOPs and activation bytes of one generator call, counted from the
    layers this call runs (forward hooks): a Conv1d 2 * out * (Cin/g) * K,
    a ConvTranspose1d 2 * in * Cout * K, a Linear 2 * out * in; bytes are
    each layer's f32 input read once and output written once (the
    elementwise LeakyReLU, sums and tanh between them not counted)."""
    import torch
    from torch import nn

    flops, nbytes = [0.0], [0.0]

    def hook(m, inputs, out):
        x = inputs[0]
        if isinstance(m, nn.ConvTranspose1d):
            flops[0] += 2.0 * x.numel() * m.out_channels * m.kernel_size[0]
        elif isinstance(m, nn.Conv1d):
            flops[0] += 2.0 * out.numel() * m.weight.shape[1] * \
                m.kernel_size[0]
        else:
            flops[0] += 2.0 * out.numel() * m.in_features
        nbytes[0] += 4.0 * (x.numel() + out.numel())

    handles = [m.register_forward_hook(hook) for m in gen.modules()
               if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d, nn.Linear))]
    try:
        with torch.no_grad():
            gen(mel, f0)
    finally:
        for h in handles:
            h.remove()
    return flops[0], nbytes[0]


def nsf_f32_sines(f0, rand_ini, upp: int, sr: int):
    """The JAX module's sines, the phase summed in f32
    (ns2vc_tpu/models/nsf_hifigan.py:56-79), on f0's device: the port sums
    it in f64 (`sine_source`), and this is why."""
    import torch

    from ns2vc_tpu_torch.models.nsf_hifigan import HARMONIC_NUM, _mod1_cumsum

    h = torch.arange(1, HARMONIC_NUM + 2, dtype=torch.float32,
                     device=f0.device)
    rad = torch.remainder(f0.float()[..., None] * h / sr, 1.0)
    rad = torch.cat([rad[:, :1] + rand_ini.to(f0.device)[:, None],
                     rad[:, 1:]], dim=1)
    phase = _mod1_cumsum(rad.repeat_interleave(upp, dim=1))
    return torch.sin(phase * (2 * np.pi)) * 0.1


def nsf_clip(sr: int) -> np.ndarray:
    """NSF_SECONDS of voiced tones with unvoiced gaps at `sr` (at 10 s:
    3 s, 1 s silent, 3 s, 0.5 s silent, 2.5 s)."""
    n = int(NSF_SECONDS * sr)
    parts = [tone(int(0.3 * n), sr, SEED + 70, 220.0),
             np.zeros(int(0.1 * n), np.float32),
             tone(int(0.3 * n), sr, SEED + 71, 180.0),
             np.zeros(int(0.05 * n), np.float32)]
    n -= sum(len(x) for x in parts)
    return np.concatenate(parts + [tone(n, sr, SEED + 72, 260.0)])


def nsf_files(tmp, sd, cfg) -> tuple[dict, int]:
    """The reconstruct script's inputs in `tmp`: the generator in the
    reference layout (weight_g / weight_v on the weight-normed convs) as
    {'generator': ...}, its config.json and the clip at NSF_IN_SR."""
    import torch

    from ns2vc_tpu_torch.models.nsf_hifigan import nsf_hifigan_to_reference
    from ns2vc_tpu_torch.utils.wavio import write_wav

    paths = {k: os.path.join(tmp, f) for k, f in (
        ("ckpt", "model"), ("config", "config.json"), ("wav", "in.wav"),
        ("out", "recon.wav"))}
    torch.save({"generator": nsf_hifigan_to_reference(sd, cfg)},
               paths["ckpt"])
    with open(paths["config"], "w") as f:
        json.dump(cfg, f)
    clip = nsf_clip(NSF_IN_SR)
    write_wav(paths["wav"], clip, NSF_IN_SR)
    return paths, len(clip)


def nsf_reconstruct(paths):
    """wav in -> wav out through scripts/torch_reconstruct_nsf.py's main():
    launch counts, ms per stage, wall ms, the waveform it returned, and
    the file it wrote with its rate."""
    from unittest import mock

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_reconstruct_nsf as recon
    from ns2vc_tpu_torch.models.nsf_hifigan import NSFHiFiGANGenerator
    from ns2vc_tpu_torch.utils.wavio import read_wav

    stages = Stages()
    patches = [mock.patch.object(obj, attr, stages.wrap(
        name, getattr(obj, attr))) for obj, attr, name in (
            (recon, "read_wav", "read and resample"),
            (recon, "resample", "read and resample"),
            (recon, "log_mel_spectrogram", "log-mel"),
            (recon, "compute_f0_dio", "DIO (host)"),
            (recon, "interpolate_f0", "DIO (host)"),
            (recon, "load_nsf_hifigan", "load"),
            (NSFHiFiGANGenerator, "forward", "generator"),
            (recon, "write_wav", "write"))]
    reset_launches()
    with contextlib.ExitStack() as stack:
        for p in patches:
            stack.enter_context(p)
        out, ms = wall_ms(lambda: recon.main([
            "--wav", paths["wav"], "--ckpt", paths["ckpt"], "--config",
            paths["config"], "--out", paths["out"]]))
    counts = module_routes()
    wav, out_sr = read_wav(paths["out"])
    return counts, dict(stages.ms), ms, out, wav, out_sr


def check_nsf_hifigan(dev):
    """The NSF-HiFiGAN vocoder at full width (the community 44.1 kHz
    configuration, seed-0 weights): wav in -> wav out through the
    reconstruct script's main() (no K1 / K2 launch), the generator alone
    at B=1 and B=4 x 10 s with PyTorch's TF32 defaults and without TF32,
    its work counted from the code, and card vs CPU in f32 without TF32:
    the generator on 2 s, both discriminators and the three losses."""
    import torch

    from ns2vc_tpu_torch.convert import init_module_, init_nsf_hifigan_params
    from ns2vc_tpu_torch.models.nsf_hifigan import (
        HARMONIC_NUM, MultiPeriodDiscriminator, MultiScaleDiscriminator,
        NSFHiFiGANGenerator, discriminator_loss, feature_loss,
        generator_kwargs, generator_loss, initial_phase, sine_source,
    )

    t_start = time.perf_counter()
    cfg = nsf_config()
    sr, hop = cfg["sampling_rate"], int(np.prod(cfg["upsample_rates"]))
    sd = init_nsf_hifigan_params(torch.Generator().manual_seed(SEED + 73),
                                 **generator_kwargs(cfg))
    gen = NSFHiFiGANGenerator(**generator_kwargs(cfg))
    gen.load_state_dict(sd)
    gen.to(dev).eval()
    n_params = sum(p.numel() for p in gen.parameters())
    res = {"params": n_params}

    # the generator alone, B x 10 s of frames
    frames = int(NSF_SECONDS * sr) // hop
    r = np.random.default_rng(SEED + 74)
    mel_all = torch.from_numpy(r.standard_normal(
        (max(NSF_BATCHES), frames, cfg["num_mels"])).astype(np.float32) - 4)
    f0_all = torch.from_numpy(r.uniform(
        100.0, 400.0, (max(NSF_BATCHES), frames)).astype(np.float32))
    f0_all[:, frames // 3: frames // 2] = 0.0
    mel_all, f0_all = mel_all.to(dev), f0_all.to(dev)
    flops, act_bytes = nsf_work(gen, mel_all[:1], f0_all[:1])
    res["work_b1"] = {"flops": flops, "activation_bytes": act_bytes,
                      "tf32_ms": flops / PEAK_TF32 * 1e3,
                      "tf32x3_ms": 3 * flops / PEAK_TF32 * 1e3,
                      "f32_cuda_cores_ms": flops / PEAK_F32_CORES * 1e3,
                      "activation_bytes_ms": act_bytes / PEAK_BYTES * 1e3}
    gen_ms = {}
    with torch.no_grad():
        for b in NSF_BATCHES:
            mel, f0 = mel_all[:b], f0_all[:b]
            for label, ctx in (("tf32_defaults", contextlib.nullcontext),
                               ("tf32_off", no_tf32)):
                with ctx():
                    gen_ms[f"b{b}_{label}"] = time_ms(
                        lambda: gen(mel, f0), warmup=2, iters=5)
    res["generator_ms"] = gen_ms
    res["x_real_time"] = {k: int(k[1:k.index("_")]) * NSF_SECONDS * 1e3 / v
                          for k, v in gen_ms.items()}
    w = res["work_b1"]
    say(f"NSF-HiFiGAN generator, {n_params / 1e6:.2f} M parameters, "
        f"{frames} frames ({NSF_SECONDS:g} s at {sr} Hz), ms per call: "
        + ", ".join(f"{k} {v:.2f} ({res['x_real_time'][k]:.0f}x real time)"
                    for k, v in gen_ms.items())
        + f"; work per B=1 call {flops / 1e12:.3f} TFLOP, convolution "
        f"activations {act_bytes / 1e9:.2f} GB; bound at B=1: TF32 "
        f"{w['tf32_ms']:.3f} ms, 3xTF32 {w['tf32x3_ms']:.3f}, f32 CUDA cores "
        f"{w['f32_cuda_cores_ms']:.3f}, activations at 3.35 TB/s "
        f"{w['activation_bytes_ms']:.3f} [{CARD}]")

    # wav in -> wav out through the entry point, twice: the first call
    # meets a frame count this process has not run
    with tempfile.TemporaryDirectory() as tmp:
        paths, n_in = nsf_files(tmp, sd, cfg)
        want_frames = -(-n_in * sr // NSF_IN_SR) // hop + 1
        res["reconstruct"] = {}
        for run in ("first", "second"):
            counts, stages, wall, out, wav, out_sr = nsf_reconstruct(paths)
            if len(out) != want_frames * hop or len(wav) != len(out) or \
                    out_sr != sr or not np.isfinite(out).all() or \
                    np.abs(out).max() > 1.0 or any(counts.values()):
                fail(f"NSF reconstruct: {len(out)} samples ({len(wav)} "
                     f"written at {out_sr} Hz), expected {want_frames} "
                     f"frames x {hop}, finite, |wav| <= 1 (max "
                     f"{np.abs(out).max()}); K1/K2 launches {counts} "
                     f"(expected none)")
            res["reconstruct"][run] = {
                "frames": want_frames, "samples": len(out),
                "stages_ms": stages, "wall_ms": wall,
                "x_real_time": NSF_SECONDS * 1e3 / wall, "launches": counts}
            parts = ", ".join(f"{k} {v:.1f}" for k, v in stages.items())
            say(f"NSF reconstruct, {run} call (scripts/torch_reconstruct_"
                f"nsf.py main): {NSF_SECONDS:g} s at {NSF_IN_SR} Hz -> "
                f"{len(out)} samples = {want_frames} frames x {hop} at {sr} "
                f"Hz, finite, max|wav| {np.abs(out).max():.3f}; ms per stage "
                f"(synchronised): {parts}; total {wall:.0f} ms = "
                f"{NSF_SECONDS * 1e3 / wall:.2f}x real time; K1/K2 launches "
                f"{counts} [{CARD}]")

    # card vs CPU, f32 without TF32
    cpu = torch.device("cpu")
    n_check = int(NSF_CHECK_SECONDS * sr) // hop
    rand_ini = initial_phase(1, HARMONIC_NUM + 1,
                             torch.Generator().manual_seed(SEED + 75))
    gen_cpu = NSFHiFiGANGenerator(**generator_kwargs(cfg))
    gen_cpu.load_state_dict(sd)
    mel, f0 = mel_all[:1, :n_check], f0_all[:1, :n_check]
    with no_tf32(), torch.no_grad():
        got = gen(mel, f0, rand_ini=rand_ini).cpu()
        want = gen_cpu.eval()(mel.cpu(), f0.cpu(), rand_ini=rand_ini)
    wav_err = (got - want).abs().max().item()
    with torch.no_grad():
        exact = sine_source(f0.cpu(), hop, sr, HARMONIC_NUM,
                            rand_ini=rand_ini)
        sines = {"f64_card_vs_cpu": sine_source(
                     f0, hop, sr, HARMONIC_NUM, rand_ini=rand_ini).cpu()
                 - exact,
                 "f32_card_vs_f64": nsf_f32_sines(
                     f0, rand_ini, hop, sr).cpu() - exact,
                 "f32_cpu_vs_f64": nsf_f32_sines(
                     f0.cpu(), rand_ini, hop, sr) - exact}
    sines = {k: v.abs().max().item() for k, v in sines.items()}

    g = torch.Generator().manual_seed(SEED + 76)
    y = torch.from_numpy(nsf_clip(sr)[None, :NSF_DISC_T].repeat(
        NSF_DISC_B, 0))
    y_hat = 0.5 * y + 0.1 * torch.randn(y.shape, generator=g)
    disc_err, loss_err = 0.0, 0.0
    for disc in (MultiPeriodDiscriminator(), MultiScaleDiscriminator()):
        init_module_(disc, g)
        with torch.no_grad():
            want = list(disc.eval()(y, y_hat))
            with no_tf32():
                got = [_nested_cpu(o) for o in disc.to(dev)(
                    y.to(dev), y_hat.to(dev))]
        for a, b in zip(_flat(got), _flat(want)):
            scale = max(b.abs().max().item(), 1e-30)
            disc_err = max(disc_err, (a - b).abs().max().item() / scale)
        for loss, args in ((discriminator_loss, (0, 1)),
                           (generator_loss, (1,)), (feature_loss, (2, 3))):
            a = loss(*(got[i] for i in args)).item()
            b = loss(*(want[i] for i in args)).item()
            loss_err = max(loss_err, abs(a - b) / abs(b))
        disc.cpu()
    res["card_vs_cpu"] = {"wav_max_abs_err": wav_err,
                          "disc_max_rel_err": disc_err,
                          "loss_max_rel_err": loss_err,
                          "sines_max_abs_err": sines}
    say(f"NSF-HiFiGAN card vs CPU, f32, TF32 off: generator on "
        f"{NSF_CHECK_SECONDS:g} s ({n_check} frames) max_abs_err "
        f"{wav_err:.3e} (tol {NSF_WAV_ATOL:g}); MPD + MSD at "
        f"{NSF_DISC_B} x {NSF_DISC_T}: outputs and feature maps "
        f"{disc_err:.3e} of each max, losses {loss_err:.3e} relative (tol "
        f"{NSF_DISC_RTOL:g}); the sines with the phase summed in f64 (the "
        f"port) card vs CPU {sines['f64_card_vs_cpu']:.3e}, summed in f32 "
        f"(the JAX module) against them: card "
        f"{sines['f32_card_vs_f64']:.3e}, CPU {sines['f32_cpu_vs_f64']:.3e} "
        f"[{CARD}]")
    if not (wav_err <= NSF_WAV_ATOL and disc_err <= NSF_DISC_RTOL
            and loss_err <= NSF_DISC_RTOL):
        fail(f"NSF-HiFiGAN card vs CPU: waveform {wav_err}, "
             f"discriminators {disc_err}, losses {loss_err}")
    res["seconds"] = round(time.perf_counter() - t_start, 1)
    res["card"] = CARD
    return res



# -- data parallel ------------------------------------------------------------

DP_B = 4                      # per process in the 2-rank run (global 8)
DP_BUCKETS = (192, 272)       # content buckets: both occur on the features
DP_STEPS, DP_TIMED = 3, 5     # compared steps, then timed steps
DP_TURN_STEPS = 4             # per turn of the world-size-1 A/B
DP_LOSS_RTOL, DP_NORM_RTOL = 2e-5, 2e-4   # JAX's own (tests/test_parallel.py)
DP_GRAD_RTOL, DP_GRAD_ATOL = 1e-3, 1e-7
DP_TIMEOUT = 300
DP_WORKER = [sys.executable, os.path.abspath(__file__),
             "--data-parallel-worker"]


def dp_config(processed, logs):
    """The 2-rank run's configuration: Config()'s widths at reduced depth
    (encoders 1 layer of 6, UNet levels 128 and 256 of the four), f32,
    dropout 0, content buckets, EMA on, the loader serial."""
    import dataclasses

    base = training_config(processed, logs)

    def enc(e):
        return dataclasses.replace(e, n_layers=1, p_dropout=0.0)
    return dataclasses.replace(
        base,
        train=dataclasses.replace(
            base.train, train_batch_size=DP_B, compute_dtype="float32",
            length_buckets=DP_BUCKETS, num_workers=0, keep_ckpts=2,
            log_every=1),
        phoneme_encoder=enc(base.phoneme_encoder),
        prompt_encoder=enc(base.prompt_encoder),
        diffusion_encoder=dataclasses.replace(
            base.diffusion_encoder, block_out_channels=(128, 256),
            p_dropout=0.0))


def params_digest(model) -> str:
    """sha256 of every parameter's bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def group_programs(tr, batches) -> dict:
    """The step and eval programs of a Trainer in a process group of one
    process over NCCL: COMPARE_STEPS replays against as many eager group
    steps from one state (`compare_compiled_step`); the group key's first
    call, capture and graph, its K1 / K2 / statistics kernel nodes held
    equal to a replay's counted launches and NCCL's kernel nodes counted
    apart; a replay's launches, backward calls and collectives held equal
    to an eager group step's; the eval program against the eager eval
    (`check_compiled_eval`)."""
    import torch

    from ns2vc_tpu_torch.parallel import mesh

    out = {"compare": compare_compiled_step(
        tr, batches, "in an NCCL group of one process")}
    # the key anew: the comparison drops its programs
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.train_step(batches[0])
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    prog = tr._step_programs[tr._step_key(batches[0], None, None)]
    counted = {}
    for name, step in (("replay", tr.train_step),
                       ("eager", tr._train_step_eager)):
        reset_launches()
        mesh.reset_counters()
        step(batches[1])
        torch.cuda.synchronize()
        counted[name] = {"launches": route_counts(),
                         "backward": backward_calls(),
                         "backward_kernels": grad_launches(),
                         "collectives": mesh.counters()}
    if counted["replay"] != counted["eager"] or prog.replays != 1:
        fail(f"group step program: a replay counts {counted['replay']}, an "
             f"eager group step {counted['eager']}; replays {prog.replays}")
    kernels, types = graph_census(prog.graph)
    nodes = graph_kernels(prog.graph)
    if nodes != kernel_totals(counted["replay"]["launches"]):
        fail(f"group step program: the graph's kernel nodes {nodes}, a "
             f"replay's counted launches "
             f"{kernel_totals(counted['replay']['launches'])}")
    nccl = {k: n for k, n in kernels.items() if "nccl" in k.lower()}
    out.update(first_call_ms=first, capture_ms=prog.capture_ms,
               nodes=prog.nodes, graph_kernel_nodes=nodes,
               nccl_nodes=sum(nccl.values()), nccl_kernels=nccl,
               node_types=dict(types), **counted["replay"])
    out["eval"] = check_compiled_eval(tr, tr.device)
    return out


def group_turns(tr, batches) -> dict:
    """Median step ms (DP_TURN_STEPS after one warm-up) in turns in this
    process: the group's step program, its eager step, and the step program
    of one process without a group (no all-reduce, its own programs), in
    the order group, eager, alone, alone, eager, group."""
    from unittest import mock

    from ns2vc_tpu_torch.train.trainer import make_train_step

    t = tr.cfg.train
    group = (tr._step_fn, True, tr._step_programs)
    alone = (make_train_step(
        tr.accum, tr.compute_dtype,
        ema_decay=t.ema_decay if t.use_ema else 0.0,
        ema_every=t.ema_update_every, max_norm=t.grad_clip_norm), False, {})
    turns = {"group": [], "eager": [], "alone": []}
    for name in ("group", "eager", "alone", "alone", "eager", "group"):
        tr._step_fn, tr.distributed, tr._step_programs = \
            alone if name == "alone" else group
        with (mock.patch.object(tr, "train_step", tr._train_step_eager)
              if name == "eager" else contextlib.nullcontext()):
            turns[name].append(median_step_ms(tr, batches, 1,
                                              DP_TURN_STEPS)[0])
    tr._step_fn, tr.distributed, tr._step_programs = group
    return turns


def data_parallel_worker(job_dir: str) -> int:
    """One rank of the data-parallel phase (`chip_smoke.py
    --data-parallel-worker DIR`): joins the group NS2VC_COORDINATOR /
    NS2VC_NUM_PROCESSES / NS2VC_PROCESS_ID describe, trains DIR/config.json
    through the Trainer (synced loader, all-reduce) as DIR/job.json says,
    and writes DIR/result_rank{r}.json. Mode "full" (NCCL): the step and
    eval programs (`group_programs`), the median replayed step, the step
    in turns (`group_turns`), and last a profiled replay and eager step.
    Mode "steps": DP_STEPS steps (losses, grad norms, geometries; the
    gradients of the first and the parameters after the last written for
    the comparison), DP_TIMED timed steps, a save, a resume on every rank
    and 2 more steps through Trainer.train."""
    from unittest import mock

    import torch
    import torch.distributed as dist

    from ns2vc_tpu_torch.config import load_config
    from ns2vc_tpu_torch.convert import init_vocos_params
    from ns2vc_tpu_torch.parallel import mesh
    from ns2vc_tpu_torch.train.trainer import Trainer

    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    dev = torch.device(job["device"])
    if job.get("f32"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if not mesh.maybe_initialize_distributed(dev, job["backend"]):
        fail("data parallel worker: no process group in the environment")
    rank, n = mesh.world()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg = load_config(os.path.join(job_dir, "config.json"))
    out = {"rank": rank, "world": n, "backend": dist.get_backend()}
    # the eval program's waveform needs a vocoder
    vsd = init_vocos_params(torch.Generator().manual_seed(SEED),
                            hop_length=cfg.data.hop_length) \
        if job["mode"] == "full" else None
    tr = Trainer(cfg, logs_folder=os.path.join(job_dir, "run"),
                 vocos_params=vsd, device=dev)
    out["compiled"] = [tr.compiled, tr.eval_compiled]
    out["n_params"] = sum(p.numel() for p in tr.model.parameters())
    loader = tr.loader()
    grads = None
    if job["mode"] == "full":
        if not (tr.compiled and tr.eval_compiled):
            fail(f"data parallel over {out['backend']}: the Trainer's step "
                 f"and eval are not programs (compiled {out['compiled']})")
        batches = [tr.device_batch(next(loader)) for _ in range(4)]
        out["batch"] = list(batches[0]["c"].shape)
        out["programs"] = group_programs(tr, batches)
        out["launches"] = out["programs"]["launches"]
        out["backward"] = out["programs"]["backward"]
        reduced = out["programs"]["collectives"]["all_reduce_mean"]
        out["all_reduce_calls"] = reduced["calls"]
        out["all_reduce_bytes"] = reduced["bytes"]
        ms, peak, m = median_step_ms(tr, batches, TRAIN_WARMUP, TRAIN_TIMED)
        out.update(step_ms=ms, peak_gb=peak, loss=m["loss"].item(),
                   grad_norm=m["grad_norm"].item())
        out["turns_ms"] = group_turns(tr, batches)
    else:
        out["losses"], out["norms"], out["geoms"] = [], [], []
        for i in range(DP_STEPS):
            b = tr.device_batch(next(loader))
            out["geoms"].append([b["c"].shape[1], b["refer"].shape[1]])
            m = tr.train_step(b)
            out["losses"].append(m["loss"].item())
            out["norms"].append(m["grad_norm"].item())
            if i == 0:
                torch.save({k: p.grad.detach().cpu() for k, p in
                            tr.model.named_parameters()},
                           os.path.join(job_dir, f"grads_rank{rank}.pt"))
        torch.save({k: v.detach().cpu() for k, v in
                    tr.model.state_dict().items()},
                   os.path.join(job_dir, f"params_rank{rank}.pt"))
        times = []
        for _ in range(DP_TIMED):
            b = tr.device_batch(next(loader))
            out["geoms"].append([b["c"].shape[1], b["refer"].shape[1]])
            sync()
            t0 = time.perf_counter()
            m = tr.train_step(b)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
            out["losses"].append(m["loss"].item())
        out["step_ms"] = float(np.median(times))
        path = tr.save()
        out["saved"] = os.path.basename(path)
        out["digest"] = params_digest(tr.model)
        tr.close()
        again = Trainer(cfg, logs_folder=os.path.join(job_dir, "run"),
                        device=dev)
        again.load()
        out["resumed_step"] = again.step
        out["digest_resumed"] = params_digest(again.model)
        out["geoms_after"] = []
        step = again.train_step

        def recorded(b, *args, **kw):
            out["geoms_after"].append([b["c"].shape[1], b["refer"].shape[1]])
            return step(b, *args, **kw)
        again.train_step = recorded
        again.train(num_steps=again.step + 2)
        out["step_after"] = again.step
        out["digest_after"] = params_digest(again.model)
        tr = again
    # the all-reduce alone, on a gradient buffer of the step's size
    flat = mesh.flat_gradients(list(tr.model.parameters()), extra=3)
    calls = mesh.all_reduce_mean.calls
    if dev.type == "cuda":
        out["all_reduce_ms"] = time_ms(lambda: mesh.all_reduce_mean(flat),
                                       warmup=2, iters=5)
    else:
        t0 = time.perf_counter()
        mesh.all_reduce_mean(flat)
        out["all_reduce_ms"] = (time.perf_counter() - t0) * 1e3
    mesh.all_reduce_mean.calls = calls
    digests = [None] * n
    dist.all_gather_object(digests, params_digest(tr.model))
    out["digests"] = digests
    if job["mode"] == "full":   # last: the profiler slows later launches
        out["profile"] = training_profile(
            tr, batches[0], out["step_ms"],
            "in an NCCL group of one process (step program replay)")
        with mock.patch.object(tr, "train_step", tr._train_step_eager):
            out["profile_eager"] = training_profile(
                tr, batches[0], float(np.mean(out["turns_ms"]["eager"])),
                "in an NCCL group of one process (eager step)")
    # the graphs hold NCCL's work: gone before its communicators
    tr.drop_programs()
    tr.close()
    with open(os.path.join(job_dir, f"result_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def run_data_parallel(job_dir: str, cfg, job: dict, n: int,
                      cmd: list | None = None) -> list:
    """Run n worker processes of data_parallel_worker (or `cmd`, another
    worker of this script) on job_dir (this script, with NS2VC_COORDINATOR
    on a free localhost port) and return their results; fails on a
    worker's failure or timeout, and leaves no worker running."""
    import socket

    from ns2vc_tpu_torch.config import save_config

    os.makedirs(job_dir, exist_ok=True)
    save_config(cfg, os.path.join(job_dir, "config.json"))
    with open(os.path.join(job_dir, "job.json"), "w") as f:
        json.dump(job, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {**os.environ, "NS2VC_COORDINATOR": f"localhost:{port}",
           "NS2VC_NUM_PROCESSES": str(n)}
    env.pop("NS2VC_DISTRIBUTED", None)
    procs, logs = [], []
    try:
        for r in range(n):
            logs.append(open(os.path.join(job_dir, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                [*(cmd or DP_WORKER), job_dir],
                env={**env, "NS2VC_PROCESS_ID": str(r)}, stdout=logs[-1],
                stderr=subprocess.STDOUT))
        deadline = time.monotonic() + DP_TIMEOUT
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        for r in bad:
            with open(os.path.join(job_dir, f"rank{r}.log")) as f:
                say(f"  rank {r} of {n} (exit {procs[r].returncode}):\n"
                    + f.read()[-3000:])
        fail(f"data parallel ({job['mode']}): ranks {bad} of {n} failed")
    results = []
    for r in range(n):
        with open(os.path.join(job_dir, f"result_rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def check_data_parallel(processed, train, dev, tmp) -> dict:
    """The Trainer over torch.distributed: a group of one process over
    NCCL at full width, where the step and the eval are programs (the
    synced loader, the all-reduce inside the step's graph; the replays bit
    for bit the eager group steps, a replay's launches, backward calls and
    collectives the eager step's and the single-process step's of the
    training phase, the eval program the eager eval's; the replay, the
    eager group step and the single-process replay in turns; the busy
    share of a replay and of an eager step), then two ranks on the one
    card over gloo (NCCL takes one rank per device), where the step stays
    eager, at reduced depth in f32 without TF32: the ranks' parameters
    bitwise equal, the step against one process on the concatenated batch
    at JAX's tolerances, the same bucket geometries on both ranks, a save
    by rank 0 and a resume on both."""
    import torch

    from ns2vc_tpu_torch.data.dataset import synced_data_loader
    from ns2vc_tpu_torch.train.trainer import Trainer

    import dataclasses

    res = {}
    backend = "nccl" if dev.type == "cuda" else "gloo"
    t0 = time.perf_counter()
    # the loader serial: its workers would load on beside the timed steps,
    # which the host bounds (the training phase times on device-resident
    # batches with no loader running)
    cfg = training_config(processed, os.path.join(tmp, "dp_logs"))
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_workers=0))
    (full,) = run_data_parallel(
        os.path.join(tmp, "dp_full"), cfg,
        {"mode": "full", "device": str(dev), "backend": backend}, 1)
    if full["launches"] != train["launches"] or \
            full["backward"] != train["backward"]:
        fail(f"data parallel step: launches {full['launches']} and backward "
             f"calls {full['backward']}, the single-process step's "
             f"{train['launches']} and {train['backward']}")
    want_bytes = 4 * (full["n_params"] + 3)
    if full["all_reduce_calls"] != 1 or full["all_reduce_bytes"] != want_bytes \
            or not np.isfinite([full["loss"], full["grad_norm"]]).all() \
            or len(set(full["digests"])) != 1:
        fail(f"data parallel step: {full['all_reduce_calls']} all-reduces of "
             f"{full['all_reduce_bytes']} bytes (expected 1 of {want_bytes}), "
             f"loss {full['loss']}, grad norm {full['grad_norm']}")
    one_ms = train["remat"]["dots"][0]
    progs, turns = full["programs"], full["turns_ms"]
    cmp_, ev = progs["compare"], progs["eval"]

    def listed(xs):
        return ", ".join(f"{x:.2f}" for x in xs)
    profiled = {k: full.get(k) or {} for k in ("profile", "profile_eager")}
    busy = {k: p.get("busy") for k, p in profiled.items()}
    say(f"data parallel, {full['world']} process over {full['backend']} at "
        f"full width ({full['n_params'] / 1e6:.1f} M parameters, batch "
        f"{full['batch'][0]} x {full['batch'][1]}, bf16, synced loader, "
        f"serial), the step and the eval as programs: median replayed step "
        f"{full['step_ms']:.2f} ms of {TRAIN_TIMED} (after {TRAIN_WARMUP} "
        f"warm-up) vs {one_ms:.2f} ms single-process, peak "
        f"{full['peak_gb']:.2f} GB; in turns in its process (median of "
        f"{DP_TURN_STEPS}) group replay {listed(turns['group'])} ms, group "
        f"eager {listed(turns['eager'])} ms, single-process replay "
        f"{listed(turns['alone'])} ms; device busy "
        + (f"{100 * busy['profile']:.0f} % of a replay "
           f"({profiled['profile']['kernel_ms']:.1f} ms of kernels), "
           f"{100 * busy['profile_eager']:.0f} % of an eager group step "
           f"({profiled['profile_eager']['kernel_ms']:.1f} ms)"
           if None not in busy.values() else "not profiled")
        + f"; the group key's first call {progs['first_call_ms']:.0f} ms "
        f"(warm-up and capture {progs['capture_ms']:.0f} ms), "
        f"{progs['nodes']} graph nodes, by type {progs['node_types']}, "
        f"K1 / K2 / statistics kernel nodes {progs['graph_kernel_nodes']} "
        f"(a replay's counted launches), NCCL kernel nodes "
        f"{progs['nccl_nodes']} {progs['nccl_kernels']}; "
        f"{COMPARE_STEPS} steps (first call, then replays "
        f"{listed(cmp_['replay_wall_ms'])} ms) bit for bit the eager group "
        f"steps from one state, default flags (loss, grad norm, draws "
        f"{cmp_['draws']}, parameters, AdamW moments, EMA); a replay's "
        f"{full['all_reduce_calls']} all-reduce of "
        f"{full['all_reduce_bytes'] / 1e6:.1f} MB, launches and backward "
        f"calls an eager group step's and the single-process step's; "
        f"all-reduce alone {full['all_reduce_ms']:.3f} ms; the eval "
        f"program's first call {ev['first_call_ms']:.0f} ms, replay "
        f"{ev['replay_ms']:.1f} ms vs eager {ev['eager_ms']:.1f} ms, bit "
        f"for bit [{CARD}]")
    res["world1"] = {k: full[k] for k in (
        "backend", "n_params", "step_ms", "peak_gb", "all_reduce_calls",
        "all_reduce_bytes", "all_reduce_ms", "turns_ms", "launches",
        "backward", "compiled")}
    res["world1"]["single_process_step_ms"] = one_ms
    res["world1"]["programs"] = {k: v for k, v in progs.items() if k not in (
        "launches", "backward")}
    res["world1"]["busy"] = busy
    res["world1"]["kernel_ms"] = {k: p.get("kernel_ms")
                                  for k, p in profiled.items()}

    job_dir = os.path.join(tmp, "dp_two")
    cfg = dp_config(processed, os.path.join(tmp, "dp_logs"))
    ranks = run_data_parallel(
        job_dir, cfg, {"mode": "steps", "device": str(dev),
                       "backend": "gloo", "f32": True}, 2)
    r0, r1 = ranks
    if any(r["compiled"] != [False, dev.type == "cuda"] for r in ranks):
        fail(f"data parallel, 2 ranks over gloo: compiled (step, eval) "
             f"{r0['compiled']}, {r1['compiled']}: the step stays eager "
             f"under gloo, the eval is a program on a card at mp = 1")
    for key in ("geoms", "losses", "digest", "saved", "resumed_step",
                "digest_resumed", "step_after", "geoms_after",
                "digest_after", "digests"):
        if r0[key] != r1[key]:
            fail(f"data parallel, 2 ranks: {key} differs: {r0[key]} vs "
                 f"{r1[key]}")
    p0, p1 = (torch.load(os.path.join(job_dir, f"params_rank{r}.pt"))
              for r in range(2))
    g0, g1 = (torch.load(os.path.join(job_dir, f"grads_rank{r}.pt"))
              for r in range(2))
    if any(not torch.equal(v, p1[k]) for k, v in p0.items()) or any(
            not torch.equal(v, g1[k]) for k, v in g0.items()):
        fail("data parallel, 2 ranks: parameters or gradients not bitwise "
             "equal")
    steps_done = DP_STEPS + DP_TIMED
    geoms = {tuple(g) for g in r0["geoms"]}
    if r0["resumed_step"] != steps_done or r0["step_after"] != steps_done \
            + 2 or r0["digest_resumed"] != r0["digest"] or len(
                {g[0] for g in geoms}) < 2:
        fail(f"data parallel, 2 ranks: resumed at {r0['resumed_step']}, "
             f"ended at {r0['step_after']} (expected {steps_done} and "
             f"{steps_done + 2}); geometries {sorted(geoms)}")

    # one process on the concatenated batches, the same t and noise: the
    # step's generator at the global batch's shape is the 2-rank draw
    with no_tf32():
        one = Trainer(cfg, logs_folder=os.path.join(tmp, "dp_one"),
                      device=dev)
        batches = synced_data_loader(one.ds, one._collator, 2 * DP_B,
                                     seed=cfg.train.seed, shard_index=0,
                                     shard_count=1)
        worst = {}
        for i in range(DP_STEPS):
            b = one.device_batch(next(batches))
            if [b["c"].shape[1], b["refer"].shape[1]] != r0["geoms"][i]:
                fail(f"data parallel: step {i} geometry "
                     f"{tuple(b['c'].shape)} vs the ranks' {r0['geoms'][i]}")
            m = one.train_step(b)
            loss, norm = m["loss"].item(), m["grad_norm"].item()
            worst[f"loss_rel_{i}"] = abs(r0["losses"][i] - loss) / abs(loss)
            worst[f"norm_rel_{i}"] = abs(r0["norms"][i] - norm) / abs(norm)
            if worst[f"loss_rel_{i}"] > DP_LOSS_RTOL or \
                    worst[f"norm_rel_{i}"] > DP_NORM_RTOL:
                fail(f"data parallel vs one process, step {i}: loss "
                     f"{r0['losses'][i]} vs {loss}, grad norm "
                     f"{r0['norms'][i]} vs {norm}")
            if i == 0:   # each error over its allowance, at most 1
                ratio = 0.0
                for k, p in one.model.named_parameters():
                    want = p.grad.detach().cpu()
                    r = ((g0[k] - want).abs() / (
                        DP_GRAD_ATOL + DP_GRAD_RTOL * want.abs())).max()
                    ratio = max(ratio, r.item())
                    if r.item() > 1.0:
                        fail(f"data parallel vs one process: gradient {k} "
                             f"{r.item():.3g} times rtol {DP_GRAD_RTOL} / "
                             f"atol {DP_GRAD_ATOL}")
                worst["grad_tolerance_used"] = ratio
        one.close()
        del one
    say(f"data parallel, 2 ranks on one card over gloo (f32, TF32 off, "
        f"{r0['n_params'] / 1e6:.1f} M parameters, batch {DP_B} per rank, "
        f"buckets {sorted(geoms)}): parameters and gradients bitwise equal "
        f"across ranks; vs one process on the concatenated batch: loss "
        f"{max(v for k, v in worst.items() if k.startswith('loss')):.2e} "
        f"(rtol {DP_LOSS_RTOL}), grad norm "
        f"{max(v for k, v in worst.items() if k.startswith('norm')):.2e} "
        f"(rtol {DP_NORM_RTOL}) over {DP_STEPS} steps, every gradient of the "
        f"first within rtol {DP_GRAD_RTOL} / atol {DP_GRAD_ATOL} (at most "
        f"{worst['grad_tolerance_used']:.3f} of it); median step "
        f"{r0['step_ms']:.2f} ms, all-reduce alone {r0['all_reduce_ms']:.3f} "
        f"ms through the host; rank 0 saved {r0['saved']}, both resumed at "
        f"step {r0['resumed_step']} and went on to {r0['step_after']} on the "
        f"same geometries [{CARD}]")
    res["two_ranks"] = {"backend": r0["backend"], "n_params": r0["n_params"],
                        "step_ms": r0["step_ms"],
                        "all_reduce_ms": r0["all_reduce_ms"],
                        "geometries": sorted(geoms), **worst}
    res["seconds"] = round(time.perf_counter() - t0, 1)
    return res


# -- tensor parallel ----------------------------------------------------------

MP_B, MP_T, MP_TR = 2, 192, 128   # the compared step's batch (data 1 x model 2)
MP_TIMED = 5                      # timed steps after the compared one
MP_GEN_STEPS = 3                  # DDIM steps of the compared sampling
MP_MEL_ATOL, MP_MEL_RTOL = 2e-5, 1e-5   # JAX's (tests/test_parallel.py)
MP_WORKER = [sys.executable, os.path.abspath(__file__),
             "--tensor-parallel-worker"]


def mp_config(logs, model_parallel: int = 2, dtype: str = "float32"):
    """The tensor-parallel phase's configuration: Config()'s widths (UNet
    levels 128/256/384/512, encoders and time embedding 256 wide) at
    reduced depth (encoders 1 layer of 6, 1 resnet per UNet block of 2),
    dropout as Config() has it, remat dots, EMA on."""
    import dataclasses

    from ns2vc_tpu_torch.config import Config, ParallelConfig

    base = Config()

    def enc(e):
        return dataclasses.replace(e, n_layers=1)
    return dataclasses.replace(
        base,
        train=dataclasses.replace(
            base.train, train_batch_size=MP_B, compute_dtype=dtype,
            num_workers=0, use_ema=True, logs_folder=logs),
        parallel=ParallelConfig(model_parallel_size=model_parallel),
        phoneme_encoder=enc(base.phoneme_encoder),
        prompt_encoder=enc(base.prompt_encoder),
        diffusion_encoder=dataclasses.replace(base.diffusion_encoder,
                                              layers_per_block=1))


def mp_case(path: str) -> dict:
    """The phase's seeded inputs (CPU tensors): a global batch, t, noise,
    and the sampler's x_T."""
    import torch

    r = np.random.default_rng(SEED + 90)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((scale * r.standard_normal(shape)).astype(
            np.float32))
    case = {"batch": {"c": f32(MP_B, MP_T, 256, scale=0.5),
                      "refer": f32(MP_B, MP_TR, 100),
                      "spec": f32(MP_B, MP_T, 100),
                      "lengths": torch.tensor([MP_T, MP_T - 40],
                                              dtype=torch.int32),
                      "refer_lengths": torch.tensor([MP_TR, MP_TR - 30],
                                                    dtype=torch.int32)},
            "t": torch.from_numpy(r.integers(0, 1000, MP_B)),
            "noise": f32(MP_B, MP_T, 100), "x_T": f32(MP_B, MP_T, 100)}
    torch.save(case, path)
    return case


def mp_step(tr, case, dev, calls=None) -> dict:
    """The compared step of a Trainer on its rows of the case's batch:
    loss, grad norm, launches and backward calls, the collectives' counts,
    and the gradients (full tensors, on the CPU)."""
    import contextlib as ctx

    import torch

    from ns2vc_tpu_torch.parallel import mesh

    batch = tr.device_batch(mesh.shard_batch(case["batch"], tr.mesh))
    reset_launches()
    mesh.reset_counters()
    with ctx.ExitStack() as stack:
        for p in (calls.patches() if calls is not None else ()):
            stack.enter_context(p)
        m = tr.train_step(batch, t=case["t"].to(dev),
                          noise=case["noise"].to(dev))
        torch.cuda.synchronize()
    out = {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
           "launches": route_counts(), "backward": backward_calls(),
           "collectives": mesh.counters()}
    grads = {k: p.grad for k, p in tr.model.named_parameters()}
    out["grads"] = {k: v.detach().to("cpu", copy=True) for k, v in
                    mesh.gather_state(grads, tr.placements, tr.mesh).items()}
    times = []
    for i in range(1 + MP_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(batch, t=case["t"].to(dev),
                      noise=case["noise"].to(dev))
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = float(np.median(times))
    return out


def mp_generate(model, case, dev, mesh=None):
    from ns2vc_tpu_torch.models.diffusion import generate_mel

    b = case["batch"]
    return generate_mel(
        model, *(b[k].to(dev) for k in ("c", "refer", "lengths",
                                        "refer_lengths")),
        x_T=case["x_T"].to(dev), method="ddim", steps=MP_GEN_STEPS,
        mesh=mesh).cpu()


def tensor_parallel_worker(job_dir: str) -> int:
    """One rank of the tensor-parallel phase (`chip_smoke.py
    --tensor-parallel-worker DIR`): joins the group NS2VC_COORDINATOR /
    NS2VC_NUM_PROCESSES / NS2VC_PROCESS_ID describe (gloo), builds the
    Trainer of DIR/config.json at its model axis, takes the compared step
    and MP_TIMED timed steps on DIR/case.pt (f32, TF32 off), samples it
    with DDIM over the mesh, saves a checkpoint, holds every K1 / K2
    geometry the step and the sampling recorded against the plain versions
    (rank 0), takes one bf16 step, and writes DIR/result_rank{r}.json (and
    rank 0 the gradients and the sample)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from ns2vc_tpu_torch.config import load_config
    from ns2vc_tpu_torch.parallel import mesh
    from ns2vc_tpu_torch.train.trainer import Trainer

    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    dev = torch.device(job["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not mesh.maybe_initialize_distributed(dev, job["backend"]):
        fail("tensor parallel worker: no process group in the environment")
    rank, n = mesh.world()
    cfg = load_config(os.path.join(job_dir, "config.json"))
    case = torch.load(os.path.join(job_dir, "case.pt"))
    t0 = time.perf_counter()
    tr = Trainer(cfg, logs_folder=os.path.join(job_dir, "run"), device=dev)
    out = {"rank": rank, "world": n, "backend": dist.get_backend(),
           "compiled": [tr.compiled, tr.eval_compiled],
           "mesh": tr.mesh.shape, "setup_s": time.perf_counter() - t0,
           "n_params_local": sum(p.numel() for p in tr.model.parameters()),
           "n_split": sum(1 for pl in tr.placements.values() if pl.axis)}
    calls = PathCalls()
    step = mp_step(tr, case, dev, calls)
    grads = step.pop("grads")
    out.update(step)
    out["replicated_digest"] = params_digest(torch.nn.ParameterList(
        [p for k, p in tr.model.named_parameters()
         if not tr.placements[k].axis]))
    tr.model.eval()
    with contextlib.ExitStack() as stack:
        for p in calls.patches():
            stack.enter_context(p)
        mel = mp_generate(tr.model, case, dev, tr.mesh)
    out["path"] = tr.save()
    full = mesh.gather_parameters(tr.model, tr.placements, tr.mesh)
    out["digest_gathered"] = params_digest(torch.nn.ParameterList(
        [torch.nn.Parameter(v) for v in full.values()]))
    if rank == 0:
        torch.save({"grads": grads, "mel": mel},
                   os.path.join(job_dir, "rank0.pt"))
        # every geometry of the split step and sampling, untimed, against
        # the plain versions in both dtypes
        g = torch.Generator(device=dev).manual_seed(SEED + 91)
        worst, k2_co = {}, set()
        for key in calls.k1:
            geo, _, scale, _ = key
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.randn(size, generator=g, device=dev)
                           .to(dtype).as_strided(shape, stride, offset)
                           for shape, stride, offset, size in geo)
                r = k1_case(q, k, v, calls.bias[key], scale, timed=False)
                if not r["err"] <= r["tol"]:
                    fail(f"tensor parallel K1 {geo[0][0]} {dtype}: error "
                         f"{r['err']} > {r['tol']}")
                worst[r["route"]] = max(worst.get(r["route"], 0.0), r["err"])
        for (bsz, t, c), _, co in calls.k2:
            k2_co.add(co)
            for dtype in (torch.float32, torch.bfloat16):
                r = k2_case(bsz, t, c, co, True, dtype, g, dev, timed=False)
                if not r["err"] <= r["tol"]:
                    fail(f"tensor parallel K2 B={bsz} T={t} C={c} Co={co} "
                         f"{dtype}: error {r['err']} > {r['tol']}")
                worst[r["route"]] = max(worst.get(r["route"], 0.0), r["err"])
        out["geometries"] = {"k1": len(calls.k1), "k2": len(calls.k2),
                             "k2_co": sorted(k2_co), "worst_err": worst}
    tr.close()
    del tr
    torch.cuda.empty_cache()
    # the bf16 step: the tensor-core routes under the split
    cfg16 = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, compute_dtype="bfloat16"))
    tr = Trainer(cfg16, logs_folder=os.path.join(job_dir, "run16"),
                 device=dev)
    batch = tr.device_batch(mesh.shard_batch(case["batch"], tr.mesh))
    reset_launches()
    m = tr.train_step(batch, t=case["t"].to(dev),
                      noise=case["noise"].to(dev))
    torch.cuda.synchronize()
    out["bf16"] = {"loss": m["loss"].item(),
                   "grad_norm": m["grad_norm"].item(),
                   "launches": route_counts(),
                   "replicated_digest": params_digest(
                       torch.nn.ParameterList(
                           [p for k, p in tr.model.named_parameters()
                            if not tr.placements[k].axis]))}
    tr.close()
    with open(os.path.join(job_dir, f"result_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def check_tensor_parallel(dev, tmp) -> dict:
    """The 'model' axis: two gloo ranks on the one card (NCCL takes one
    rank per device; NCCL between cards is not run here) laid out data 1 x
    model 2, at Config()'s widths and reduced depth, f32 with TF32 off:
    the split step against one process on the same batch and draws (JAX's
    tolerances for a mesh against one device), the replicas' bits, K1 and
    K2 launches per rank against one process's (K2 at the local Co),
    `generate_mel` over the mesh against one process, a save at mp=2 that
    one process resumes, every recorded geometry against the plain
    versions, and one bf16 step through the tensor-core routes."""
    import dataclasses

    import torch

    from ns2vc_tpu_torch.config import ParallelConfig
    from ns2vc_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    job_dir = os.path.join(tmp, "mp_two")
    os.makedirs(job_dir, exist_ok=True)
    cfg = mp_config(os.path.join(tmp, "mp_logs"))
    case = mp_case(os.path.join(job_dir, "case.pt"))
    ranks = run_data_parallel(job_dir, cfg, {"device": str(dev),
                                             "backend": "gloo",
                                             "mode": "tensor parallel"}, 2,
                              MP_WORKER)
    r0, r1 = ranks
    if any(r["compiled"] != [False, False] for r in ranks):
        fail(f"tensor parallel over gloo: compiled (step, eval) "
             f"{r0['compiled']}, {r1['compiled']}: both stay eager")
    saved = torch.load(os.path.join(job_dir, "rank0.pt"))
    for key in ("loss", "grad_norm", "launches", "backward", "collectives",
                "replicated_digest", "digest_gathered", "path"):
        if r0[key] != r1[key]:
            fail(f"tensor parallel: {key} differs between the ranks: "
                 f"{r0[key]} vs {r1[key]}")
    if r0["bf16"]["replicated_digest"] != r1["bf16"]["replicated_digest"] \
            or not np.isfinite([r0["bf16"]["loss"],
                                r0["bf16"]["grad_norm"]]).all() \
            or r0["bf16"]["launches"]["affine_silu_conv1d_tc"] == 0 \
            or r0["bf16"]["launches"]["flash_attention_tc"] == 0:
        fail(f"tensor parallel bf16 step: {r0['bf16']} vs {r1['bf16']}")
    k2_co = r0["geometries"]["k2_co"]
    if not {128, 192, 256} <= set(k2_co):
        fail(f"tensor parallel: K2 took Co {k2_co}; the split resnet convs "
             f"give 128, 192 and 256")

    res = {"mesh": r0["mesh"], "backend": r0["backend"]}
    with no_tf32():
        one_cfg = dataclasses.replace(cfg, parallel=ParallelConfig())
        one = Trainer(one_cfg, logs_folder=os.path.join(tmp, "mp_one"),
                      device=dev)
        n_params = sum(p.numel() for p in one.model.parameters())
        step = mp_step(one, case, dev)
        worst = {"loss_rel": abs(r0["loss"] - step["loss"]) / abs(
            step["loss"]), "norm_rel": abs(r0["grad_norm"] - step[
                "grad_norm"]) / abs(step["grad_norm"])}
        if worst["loss_rel"] > DP_LOSS_RTOL or \
                worst["norm_rel"] > DP_NORM_RTOL:
            fail(f"tensor parallel vs one process: loss {r0['loss']} vs "
                 f"{step['loss']}, grad norm {r0['grad_norm']} vs "
                 f"{step['grad_norm']}")
        ratio = 0.0
        for k, want in step["grads"].items():
            r = ((saved["grads"][k] - want).abs() / (
                DP_GRAD_ATOL + DP_GRAD_RTOL * want.abs())).max().item()
            ratio = max(ratio, r)
            if r > 1.0:
                fail(f"tensor parallel vs one process: gradient {k} {r:.3g} "
                     f"times rtol {DP_GRAD_RTOL} / atol {DP_GRAD_ATOL}")
        worst["grad_tolerance_used"] = ratio
        if r0["launches"] != step["launches"] or \
                r0["backward"] != step["backward"]:
            fail(f"tensor parallel: launches {r0['launches']} and backward "
                 f"calls {r0['backward']} per rank, one process "
                 f"{step['launches']} and {step['backward']}")
        one.close()
        # the mp=2 checkpoint resumed by one process, and its sample
        again = Trainer(one_cfg, logs_folder=os.path.join(tmp, "mp_one"),
                        device=dev)
        again.load(path=r0["path"])
        if params_digest(again.model) != r0["digest_gathered"]:
            fail("tensor parallel: the mp=2 checkpoint resumed at mp=1 is "
                 "not the ranks' gathered parameters")
        again.model.eval()
        mel = mp_generate(again.model, case, dev)
        mel_err = (saved["mel"] - mel).abs().max().item()
        if not torch.allclose(saved["mel"], mel, atol=MP_MEL_ATOL,
                              rtol=MP_MEL_RTOL) or not torch.isfinite(
                                  mel).all():
            fail(f"tensor parallel generate_mel vs one process: max error "
                 f"{mel_err}")
        resumed_step = again.step
        again.close()
        del one, again
    torch.cuda.empty_cache()
    coll = r0["collectives"]
    say(f"tensor parallel, data 1 x model 2: 2 ranks on one card over gloo "
        f"(host copies; NCCL between cards is not run on a one-card "
        f"machine), Config() widths at reduced depth (encoders 1 layer of "
        f"6, 1 resnet per UNet block of 2; {n_params / 1e6:.1f} M "
        f"parameters, {r0['n_params_local'] / 1e6:.1f} M per rank, "
        f"{r0['n_split']} split), batch {MP_B} x {MP_T}, f32, TF32 off, "
        f"dropout on: vs one process loss {worst['loss_rel']:.2e} (rtol "
        f"{DP_LOSS_RTOL}), grad norm {worst['norm_rel']:.2e} (rtol "
        f"{DP_NORM_RTOL}), every gradient within rtol {DP_GRAD_RTOL} / atol "
        f"{DP_GRAD_ATOL} (at most {ratio:.3f} of it); replicated parameters "
        f"bitwise equal across ranks; launches per rank {r0['launches']} = "
        f"one process's, K2 at local Co {k2_co}; per step "
        f"{coll['all_gather']['calls']} all-gathers "
        f"({coll['all_gather']['bytes'] / 1e6:.1f} MB), "
        f"{coll['all_reduce_sum']['calls']} all-reduce sums "
        f"({coll['all_reduce_sum']['bytes'] / 1e6:.1f} MB), "
        f"{coll['all_reduce_mean']['calls']} all-reduce means "
        f"({coll['all_reduce_mean']['bytes'] / 1e6:.1f} MB); median step "
        f"{r0['step_ms']:.1f} / {r1['step_ms']:.1f} ms per rank (gloo "
        f"through host copies on one card, not NCCL) vs "
        f"{step['step_ms']:.1f} ms in one process (step program "
        f"replays); generate_mel DDIM "
        f"{MP_GEN_STEPS} steps over the mesh vs one process max error "
        f"{mel_err:.2e} (atol {MP_MEL_ATOL}, rtol {MP_MEL_RTOL}); saved at "
        f"mp=2, resumed at mp=1 at step {resumed_step}; "
        f"{r0['geometries']['k1']} K1 and {r0['geometries']['k2']} K2 "
        f"geometries against the plain versions, worst "
        f"{r0['geometries']['worst_err']}; bf16 step loss "
        f"{r0['bf16']['loss']:.4f}, launches {r0['bf16']['launches']} "
        f"[{CARD}]")
    res.update(worst, n_params=n_params,
               n_params_per_rank=r0["n_params_local"], n_split=r0["n_split"],
               launches_per_rank=r0["launches"],
               backward_per_rank=r0["backward"], k2_co=k2_co,
               collectives_per_step=coll, step_ms_per_rank=[
                   r0["step_ms"], r1["step_ms"]],
               step_ms_one_process=step["step_ms"], mel_max_err=mel_err,
               geometries=r0["geometries"], bf16=r0["bf16"],
               setup_s=r0["setup_s"],
               seconds=round(time.perf_counter() - t0, 1), card=CARD)
    return res


def _nested_cpu(x):
    return [_nested_cpu(v) for v in x] if isinstance(x, list) else x.cpu()


def _flat(x):
    return [t for v in x for t in _flat(v)] if isinstance(x, list) else [x]


def main() -> int:
    from unittest import mock

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        from ns2vc_tpu_torch.config import Config
        from ns2vc_tpu_torch.convert import init_params, init_vocos_params
        from ns2vc_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    global CARD, SM_CLOCK_MHZ
    CARD = card_line()
    SM_CLOCK_MHZ = sm_clock_mhz()
    say(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {CARD}")

    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    say(f"build: {info.path.name} in {info.seconds:.1f} s "
        f"(first use {time.perf_counter() - t0:.1f} s)")
    for line in info.log.splitlines():
        if "ptxas info" in line and ("Used" in line or "spill" in line):
            say(f"  {line.strip()}")

    cfg = Config()
    gen = torch.Generator().manual_seed(SEED)
    sd = init_params(cfg, gen)
    vsd = init_vocos_params(gen, hop_length=cfg.data.hop_length)
    with torch.device("meta"):
        from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
        unet = NaturalSpeech2(cfg).diff_model.unet

    seconds = {}

    @contextlib.contextmanager
    def phase(name):
        t_start = time.perf_counter()
        yield
        seconds[name] = round(time.perf_counter() - t_start, 1)

    # the end-to-end timings first, in a process that has run nothing but
    # the build; then the kernels at every shape (their many CUDA-graph
    # captures), the CPU references of the front end, and the profiles
    with phase("serving"):
        svc, svc32, clips, refer, walls, served = check_serving(
            cfg, sd, vsd, dev)
        check_samplers(svc, clips, refer, cfg.data.hop_length,
                       cfg.data.sampling_rate)
        check_overlap(svc, refer)
        batcher = check_microbatcher(svc, refer, cfg.data.hop_length)
    with phase("compiled serving"):
        compiled = check_compiled_serving(cfg, sd, vsd, svc, svc32, clips,
                                          refer, dev)
        compiled["microbatcher"] = batcher
    cv_sd, crepe_sd = front_end_weights()
    with phase("CLI runs"):
        counts, f32_counts, path_calls = check_cli(cfg, sd, vsd, cv_sd,
                                                   crepe_sd)
    # training: the features, the trainer and its loader live in train_tmp
    # until the training profile at the end
    train_tmp = tempfile.TemporaryDirectory()
    with phase("training"):
        trainer, train_batches, train = check_training(vsd, cv_sd, dev,
                                                       train_tmp.name)
        torch.cuda.empty_cache()
    with phase("f0 predictor"):
        f0, f0_trainer, f0_batches = check_f0_predictor(
            svc, clips, refer, vsd, cv_sd, crepe_sd, train, trainer,
            train_batches, dev, train_tmp.name)
        torch.cuda.empty_cache()
    with phase("model modules"):
        modules = check_model_modules(cfg, sd, dev)
        torch.cuda.empty_cache()
    with phase("nsf hifigan"):
        nsf = check_nsf_hifigan(dev)
        torch.cuda.empty_cache()
    with phase("data parallel"):
        dp = check_data_parallel(os.path.join(train_tmp.name,
                                              "raw_processed"),
                                 train, dev, train_tmp.name)
        torch.cuda.empty_cache()
    with phase("tensor parallel"):
        tp = check_tensor_parallel(dev, train_tmp.name)
    with no_tf32():
        with phase("K1 shapes"):
            k1_all, k1_step, k1_step1 = check_attention(cfg, dev)
        with phase("K2 shapes"):
            k2_all, k2_step = check_resnet(unet, dev)
        with phase("full model"):
            check_full_model(cfg, sd, vsd, dev)
        with phase("CLI geometries"):
            on_path = check_path_calls(path_calls, dev)
    with phase("front end"):
        check_front_end(dev, cv_sd, crepe_sd)
    # last: the profiler slows the launches of whatever runs after it
    with phase("profiles"):
        bf16_serving = serving_profile(lambda: svc.infer_batch(
            clips, refer, sampling_timesteps=STEPS, order=2,
            output="pcm16"), walls["batch"], f"serving B={B}")
        single = serving_profile(lambda: svc.infer_from_features(
            clips[0], refer, sampling_timesteps=STEPS, order=2),
            walls["single"], "single request B=1")
        f32_serving = serving_profile(lambda: svc32.infer_batch(
            clips, refer, sampling_timesteps=STEPS, order=2,
            output="pcm16"), walls["batch_f32"], f"serving B={B} f32")
        # the same calls through the eager body, against its own wall time
        for name, s, cl, out, graph in (
                ("b16_bf16_pcm16", svc, clips, "pcm16", bf16_serving),
                ("b1_bf16_f32out", svc, clips[:1], "float32", single),
                ("b16_f32_pcm16", svc32, clips, "pcm16", f32_serving)):
            case = compiled["cases"][name]
            with eager_body(s):
                eager = serving_profile(lambda: s.infer_batch(
                    cl, refer, sampling_timesteps=STEPS, order=2,
                    output=out), float(np.mean(case["eager_ms"])),
                    f"{name} eager body", replay=False)
            graph_wall = float(np.mean(case["graph_ms"]))
            case.update(eager_kernel_ms=eager["kernel_ms"],
                        graph_kernel_ms=graph["kernel_ms"],
                        eager_busy=eager["busy"],
                        graph_busy=graph["kernel_ms"] / graph_wall)
            say(f"compiled serving {name}: kernel time {eager['kernel_ms']:.1f}"
                f" ms eager, {graph['kernel_ms']:.1f} ms graph; device busy "
                f"{100 * case['eager_busy']:.0f} % of the eager call "
                f"({float(np.mean(case['eager_ms'])):.1f} ms), "
                f"{100 * case['graph_busy']:.0f} % of the replay "
                f"({graph_wall:.1f} ms) [{CARD}]")
        step_kernels = k2_step_kernels(unet, dev)
        # a replay of the step program, then the eager step
        for tr, res, bs, title in (
                (trainer, train, train_batches, ""),
                (f0_trainer, f0["training"], f0_batches,
                 "with the F0 predictor")):
            fig = res["compiled"]["figures"]
            res["profile"] = training_profile(
                tr, bs[0], float(np.mean(fig["compiled_ms"])),
                f"{title} (step program replay)".strip())
            with mock.patch.object(tr, "train_step", tr._train_step_eager):
                res["profile_eager"] = training_profile(
                    tr, bs[0], float(np.mean(fig["eager_ms"])),
                    f"{title} (eager step)".strip())
    trainer.close()
    f0_trainer.close()
    train_tmp.cleanup()
    say(f"seconds per phase: {seconds}; total "
        f"{time.perf_counter() - t0:.1f} s")

    kernels = []
    for route, (source, replaces) in ROUTES.items():
        # the bf16 CLI run takes no f32 resnet call and no f32 call of one
        # query: those routes' launches are the f32 CLI run's (through the
        # kernels, TF32 off)
        f32_only = route in ("affine_silu_conv1d_f32tc",
                             "flash_attention_f32tc_q1")
        launches = (f32_counts if f32_only else counts)[route]
        if launches == 0 or on_path.calls[route] == 0:
            fail(f"{route}: {launches} launches on its CLI run, "
                 f"{on_path.calls[route]} calls timed")
        s = on_path.sums[route]
        geo = train["geometries"].get(route, {})
        # backward_calls() does not count tc_narrow apart
        t_launch, t_bwd = train["launches"][route], train["backward"].get(
            route)
        pre = train["preprocess_launches"][route]
        if (t_launch if route.endswith("_tc") or route == "group_norm_affine"
                else pre if route in ("flash_attention_f32tc",
                                      "flash_attention_f32tc_wgmma")
                else 1) == 0:
            fail(f"{route}: {t_launch} launches per training step, {pre} in "
                 f"the preprocess run")
        # this slice's paths: the F0 predictor's serving call
        # (auto_predict_f0, counted), its cross-attention geometry and the
        # op registry's D = 128 (timed)
        f0_k1 = f0["k1"].get(route)
        d128 = next((r for r in modules["d128"].values()
                     if r["route"] == route), None)
        extra_err = [r["err"] for r in (f0_k1, *modules["d128"].values())
                     if r is not None and r["route"] == route]
        slice5 = {"f0_serving_launches": f0["serving"]["launches"].get(
            route, 0)}
        for prefix, r in (("f0_predictor", f0_k1), ("d128", d128)):
            if r is not None:
                slice5.update({f"{prefix}_ms": r["ms"],
                               f"{prefix}_plain_ms": r["plain"],
                               f"{prefix}_bound_ms": r["bound"],
                               f"{prefix}_bound_by": r["bound_by"],
                               f"{prefix}_library_ms": r["lib"],
                               f"{prefix}_max_abs_err": r["err"]})
        # this slice's: the route's launches in the B=16 serving call of
        # its dtype (f32 for the 3xTF32 routes: Svc's default), the summed
        # times of one UNet step's calls, and the f32 serving call
        st = (k1_step if route.startswith("flash") else k2_step)
        ss = st.sums.get(route, {})
        # the compiled serving path: a replay of its phase, of the
        # route's dtype, counted with the counts set to 0 just before it
        replayed = compiled["cases"]["b16_f32_pcm16" if "f32tc" in route
                                     else "b16_bf16_pcm16"]["launches"][route]
        if replayed == 0:
            fail(f"{route}: no launch in the compiled serving phase's replay")
        slice6 = {"serving_launches": served[route],
                  "compiled_serving_launches": replayed,
                  **{f"serving_step_{name}": ss.get(key) for key, name in (
                      ("ms", "ms"), ("plain", "plain_ms"),
                      ("bound", "bound_ms"), ("lib", "library_ms"),
                      ("conv", "conv_alone_ms"))},
                  "serving_step_bound_by": st.bound_by(route)}
        if "f32tc" in route:
            slice6["f32_serving_profiled_ms"] = f32_serving[
                "k1_q1_ms" if route.endswith("_q1") else "k1_f32_wgmma_ms"
                if route.endswith("_wgmma") else "k1_ms"
                if route.startswith("flash") else "k2_ms"]
        if route.startswith("flash_attention_f32tc") and \
                not route.endswith("_q1"):
            # this slice's: one f32 UNet step's calls at B=1
            ss1 = k1_step1.sums.get(route, {})
            slice6.update({f"serving_b1_step_{name}": ss1.get(key)
                           for key, name in (
                               ("ms", "ms"), ("old", "mma_sync_kernel_ms"),
                               ("plain", "plain_ms"), ("bound", "bound_ms"),
                               ("lib", "library_ms"))})
        # this slice's: the profiled serving calls, and the statistics
        # kernel's f32 serving (Svc's default dtype) beside its bf16
        profiled = {"flash": "k1_ms", "affine": "k2_ms", "group": "gn_ms"}[
            route.split("_")[0]]
        if route in K1_SUB.values():   # by kernel: wgmma, mma.sync, q1
            profiled = ("k1_wgmma_ms" if route == "flash_attention_tc_wgmma"
                        else "k1_q1_ms" if route.endswith("_q1")
                        else "k1_tc_ms")
        if "f32tc" not in route:
            slice6["serving_profiled_ms"] = bf16_serving[profiled]
            slice6["single_profiled_ms"] = single[profiled]
        if route == "group_norm_affine":
            ss32 = k2_step.sums.get("group_norm_affine_f32", {})
            slice6.update({
                "f32_serving_launches": served["group_norm_affine_f32"],
                "f32_serving_profiled_ms": f32_serving["gn_ms"],
                **{f"f32_serving_step_{name}": ss32.get(key) for key, name in (
                    ("ms", "ms"), ("plain", "plain_ms"),
                    ("bound", "bound_ms"), ("lib", "library_ms"))},
                "kernels_per_unet_step_k2": step_kernels})
        kernels.append({
            "name": route, "route": "cuda",
            "source": f"ns2vc_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches,
            "launches_from": "cli_f32" if f32_only else "cli_bf16",
            "max_abs_err": max(k1_all.err[route], k2_all.err[route],
                               on_path.err[route], *extra_err),
            "ms": s["ms"], "eager_ms": s["eager"], "plain_ms": s["plain"],
            "bound_ms": s["bound"],
            "bound_by": on_path.bound_by(route),
            "library_ms": s["lib"] if "lib" in s else None,
            **({"conv_alone_ms": s["conv"]} if "conv" in s else {}),
            # K1 bf16: the mma.sync kernel at the same calls, in turns
            **({"mma_sync_kernel_ms": s["old"],
                "serving_step_mma_sync_kernel_ms": k1_step.sums[route].get("old"),
                "train_mma_sync_kernel_ms": geo.get("old_fwd_ms")}
               if "old" in s else {}),
            # K1 f32 of one query: the 3xTF32 kernel at the same calls
            **({"f32tc_kernel_ms": s["prior"]} if "prior" in s else {}),
            "train_launches_per_step": t_launch,
            "train_backward_calls_per_step": t_bwd,
            "preprocess_launches": pre,
            "train_ms": geo.get("fwd_ms"), "train_plain_ms": geo.get(
                "plain_ms"), "train_library_ms": geo.get("lib_ms"),
            "train_bound_ms": geo.get("bound"),
            "train_backward_ms": geo.get("bwd_ms"),
            # K2: the step's backward is the backward kernels; cuDNN's
            # path (the plain backward) beside it
            **({"train_backward_plain_ms": geo["bwd_plain_ms"]}
               if "bwd_plain_ms" in geo else {}),
            "train_backward_bound_ms": geo.get("bwd_bound"),
            "train_backward_bound_by": geo.get("bwd_by"),
            "train_backward_max_err": geo.get("err"),
            "tensor_parallel_launches_per_rank_step": tp[
                "launches_per_rank"][route], **slice5, **slice6})
    # K2's backward kernels: launched on the training step's path (bf16)
    # and the f32 card gradients' (f32), counted with the counts set to 0
    # just before; timed and held against the plain backward at the step's
    # geometries
    bwd_launches = {
        "affine_silu_conv1d_backward_bf16": (
            train["grad_launches"]["affine_silu_conv1d_backward_bf16"],
            "train_step_bf16"),
        "affine_silu_conv1d_backward_f32": (
            train["grad_f32_backward_launches"], "train_grads_f32")}
    for route, (source, replaces) in BACKWARD_ROUTES.items():
        d = train["geometries"][route]
        launches, launches_from = bwd_launches[route]
        if launches == 0:
            fail(f"{route}: no launch on {launches_from}")
        kernels.append({
            "name": route, "route": "cuda",
            "source": f"ns2vc_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": launches, "launches_from": launches_from,
            "max_abs_err": d["abs_err"], "max_rel_err": d["err"],
            "ms": d["ms"], "plain_ms": d["plain"],
            "plain_deterministic_ms": d["plain_det"],
            "bound_ms": d["bound"], "bound_by": d["bound_by"],
            "library_ms": None,
            "timed_at": f"the bf16 training step's {int(d['calls'])} K2 "
                        f"backward calls, B={TRAIN_B}, in "
                        f"{route.rsplit('_', 1)[1]}"})
    print(json.dumps({"f0_predictor": {
        "serving": f0["serving"], "cli_ms": f0["cli_ms"],
        "card_vs_cpu": f0["card_vs_cpu"],
        **{k: f0[k] for k in ("pred_bf16_rel_rms", "pred_bf16_max_abs_err",
                              "pred_scale")},
        "training": f0["training"]}}))
    print(json.dumps({"model_modules": {
        "op_registry_worst": {f"{k[0]} {k[1]}": v for k, v in
                              modules["op_registry_worst"].items()},
        "cfg_sample_ms": modules["cfg_sample_ms"],
        "lora_err": modules["lora_err"],
        "stream_errs": modules["stream_errs"]}}))
    print(json.dumps({"compiled_serving": compiled}))
    print(json.dumps({"nsf_hifigan": nsf}))
    print(json.dumps({"data_parallel": dp}))
    print(json.dumps({"tensor_parallel": tp}))
    print(json.dumps({"training": {
        k: v for k, v in train.items()
        if k not in ("geometries", "launches", "backward")}}))
    print(json.dumps({"kernels": kernels}))
    print(CARD)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--data-parallel-worker":
        sys.exit(data_parallel_worker(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--tensor-parallel-worker":
        sys.exit(tensor_parallel_worker(sys.argv[2]))
    sys.exit(main())
