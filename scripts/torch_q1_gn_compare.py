"""The single-query backward and the GroupNorm statistics kernel against the
kernels they replaced, on one GPU, in turns.

    git show b4257f4:ns2vc_tpu_torch/csrc/flash_attention_bwd_wgmma.cu \\
        > .scratch/old_bwd.cu
    for f in group_norm_affine gn_silu_conv1d_tc gn_silu_conv1d; do
        git show b4257f4:ns2vc_tpu_torch/csrc/$f.cu > .scratch/old_$f.cu
    done
    python3 scripts/torch_q1_gn_compare.py --old-bwd .scratch/old_bwd.cu \\
        --old-gn .scratch/old_group_norm_affine.cu \\
        --old-conv .scratch/old_gn_silu_conv1d_tc.cu \\
        --old-conv-f32 .scratch/old_gn_silu_conv1d.cu [--out FILE]

The old sources are compiled with nvcc into the gitignored `.scratch/`
(with `ns2vc_tpu_torch/csrc` on the include path) and bound with ctypes;
so is the current tree's statistics and conv sources with
-DNS2VC_PDL=0 (no programmatic dependent launch). A statistics or conv
call through the port's wrappers runs one of these libraries where the
script puts it in `_build.library()`'s place (the entries keep their
arguments), so every variant is timed through the same Python.

It reports, every time with the card's name and power limit:
- the single-query backward at the pools of a `Config()` training step
  (B = 32 bf16: `ref_enc` 1 x 1 query over 273 keys x 100, `add_embedding`
  64 x 1 over 273 x 4) and of the f32 gradient checks (B = 2, f32): old,
  new, new, old, each the device time of 10 calls captured as one CUDA
  graph (`chip_smoke.graph_ms`), SDPA's backward of the backend its
  dispatcher picks (forward and backward less forward), the plain
  backward, the bound (`chip_smoke.k1_backward_bound`), both kernels'
  errors against the plain backward and a bitwise repeat of the new one;
- the statistics kernel at the 45 calls of one UNet step (B = 16 bf16,
  B = 16 f32, B = 1 bf16) and at the training UNet's 45 geometries (B =
  32 x 272 bf16): old, new, new, old, with torch.var_mean and the bound
  (`chip_smoke.gn_bound`), its errors against the plain version and a
  bitwise repeat;
- at B = 1 the new kernel with 1, 2 and 4 blocks per slab (a cluster
  split), in turns;
- the chain, statistics then the K2 conv at each of the B = 16 bf16
  step's 45 geometries, as one CUDA graph: old kernels, new, new without
  programmatic dependent launch, the plain versions (f32 cuDNN conv), the
  library chain (torch.var_mean and the fold, then cuDNN's conv1d in
  bf16), and back;
- with --launch-floor, the statistics kernel with its reads of x and its
  merges taken out (the least a launch of it costs in a graph), and with
  --gn-variant NAME=SOURCE any other statistics source, beside the others
  at B = 16 bf16 and in the chain;
- one B = 16 bf16 and one B = 1 serving replay (`Svc`, 50 UniPC steps)
  with the old statistics and conv kernels in the serving program against
  the new ones, in turns (wall ms of a replay).
A JSON line {"q1_gn_compare": ...} last (also to --out). Card only;
imports nothing of JAX.
"""

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "ns2vc_tpu_torch", "csrc")
GN_SOURCES = ("group_norm_affine.cu", "gn_silu_conv1d_tc.cu",
              "gn_silu_conv1d.cu")


class Variant:
    """A kernel library for the wrappers: its own entries where it has them,
    the port's library's for the rest (error strings, other kernels)."""

    def __init__(self, lib, main, drops=None):
        self.lib, self.main, self.drops = lib, main, drops or {}

    def __getattr__(self, name):
        try:
            entry = getattr(self.lib, name)
        except AttributeError:
            return getattr(self.main, name)
        if name not in self.drops:
            return entry
        i = self.drops[name]
        return lambda *args: entry(*args[:i], *args[i + 1:])


# the arguments the old kernels' entries lack (their position in today's):
# the statistics block's threads, the convs' programmatic-launch flag
OLD_DROPS = {"ns2vc_group_norm_affine": 16,
             "ns2vc_affine_silu_conv1d_tc": 14,
             "ns2vc_affine_silu_conv1d_f32tc": 14}


def launch_floor_source() -> str:
    """The statistics kernel with its reads of x and its merges taken out
    (it still waits on the kernel before it, lets the next one launch and
    writes a and b from the parameters), written into .scratch/: timed as
    the variant "floor", the least a launch of this shape costs in a
    graph."""
    src = open(os.path.join(CSRC, "group_norm_affine.cu")).read()
    a = src.index("  Moments m = {0.f, 0.f, 0.f};\n  for (int base = tid;")
    b = src.index("  if (S > 1) cluster_sync();   // block 0 has read every")
    body = """  if constexpr (kPdl) launch_dependents();
  if (folder) {
    float* ar = a_out + int64_t(b) * C + g * cg;
    float* br = b_out + int64_t(b) * C + g * cg;
    for (int i = 0; i < kPre; ++i) {
      const int c = lane + 32 * i;
      if (c < cg) {
        ar[c] = gp[i] + sp[i];
        br[c] = bp[i] + hp[i];
      }
    }
  }
"""
    out = os.path.join(ROOT, ".scratch", "group_norm_affine_floor.cu")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write(src[:a] + body + src[b:])
    return out


def build_variants(specs: dict, old=()) -> dict:
    """name -> (sources, extra nvcc flags): one shared library each, built
    in parallel into .scratch/, bound with the port's signatures (the
    libraries named in `old` without the arguments of OLD_DROPS)."""
    from ns2vc_tpu_torch.ops import _build

    jobs = {}
    for name, (sources, flags) in specs.items():
        h = hashlib.sha256(" ".join(flags).encode())
        for s in sources:
            h.update(open(s, "rb").read())
        for s in os.listdir(CSRC):
            if s.endswith(".cuh"):
                h.update(open(os.path.join(CSRC, s), "rb").read())
        out = os.path.join(ROOT, ".scratch",
                           f"lib{name}_{h.hexdigest()[:12]}.so")
        proc = None
        if not os.path.exists(out):
            os.makedirs(os.path.dirname(out), exist_ok=True)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-I", CSRC,
                   "-shared", *sources, "-o", out, *_build.LINK_FLAGS]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        jobs[name] = (out, proc)
    main = _build.library()
    libs = {}
    for name, (out, proc) in jobs.items():
        if proc is not None:
            log = proc.communicate()[0]
            if proc.returncode != 0:
                cs.fail(f"{name} build: {log[-4000:]}")
            for line in log.splitlines():
                if "ptxas info" in line and ("Used" in line
                                             or "spill" in line):
                    cs.say(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(out)
        drops = OLD_DROPS if name in old else {}
        for entry, argtypes in _build._SIGNATURES.items():
            if hasattr(lib, entry):
                if entry in drops:
                    argtypes = [t for i, t in enumerate(argtypes)
                                if i != drops[entry]]
                getattr(lib, entry).argtypes = argtypes
                getattr(lib, entry).restype = ctypes.c_int
        libs[name] = Variant(lib, main, drops)
    return libs


@contextlib.contextmanager
def using(lib):
    """The wrappers launch `lib`'s entries (None: the port's library)."""
    from unittest import mock

    from ns2vc_tpu_torch.ops import _build

    if lib is None:
        yield
        return
    with mock.patch.object(_build, "library", lambda: lib):
        yield


def using_call(lib, fn, *args):
    with using(lib):
        return fn(*args)


def turns(calls: dict, order) -> dict:
    """graph_ms of each call in the given order; the mean per name."""
    got = defaultdict(list)
    for name in order:
        got[name].append(cs.graph_ms(calls[name]))
    return {name: float(np.mean(v)) for name, v in got.items()}


# -- the single-query backward ------------------------------------------------

def old_q1(lib, q, k, v, bias, scale, do):
    """A closure launching the old single-query backward (its entry takes
    no plan): (dq, dk, dv) as the wrapper allocates them."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    entry = (lib.ns2vc_flash_attention_bwd_q1 if q.dtype == torch.bfloat16
             else lib.ns2vc_flash_attention_bwd_q1_f32)
    entry.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_int64] * 21 + [ctypes.c_float, ctypes.c_void_p]
    entry.restype = ctypes.c_int

    def run():
        grads = [torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
                 .permute(0, 2, 1, 3) for t in (tq, tk, tk)]
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if bias is None else bias.data_ptr(), do.data_ptr(),
                    *(t.data_ptr() for t in grads), None, b, h, tq, tk, d,
                    *(s for t in (q, k, v, do, *grads)
                      for s in t.stride()[:3]),
                    float(scale), torch.cuda.current_stream().cuda_stream)
        if err:
            cs.fail(f"old single-query backward: CUDA error {err}")
        return grads
    return run


def pool_inputs(g, b, h, tk, d, dtype):
    """q, k, v, dO of one pool as the step lays them out: head views of
    (B, T, C) projections."""
    from ns2vc_tpu_torch.ops.attention import split_heads

    c = h * d
    q, k, v, do = (split_heads(torch.randn(b, t, c, generator=g,
                                           device="cuda").to(dtype), h)
                   for t in (1, tk, tk, 1))
    return q, k, v, do


def q1_case(old_lib, name, b, h, tk, d, dtype):
    from ns2vc_tpu_torch.ops.flash_attention import (
        flash_attention_backward, flash_attention_grad, plan_q1_backward,
    )

    g = torch.Generator(device="cuda").manual_seed(b * h + d)
    q, k, v, do = pool_inputs(g, b, h, tk, d, dtype)
    scale = d ** -0.5
    new = lambda: flash_attention_grad(q, k, v, None, scale, do)  # noqa: E731
    old = old_q1(old_lib, q, k, v, None, scale, do)
    got, again, was = new(), new(), old()
    want = flash_attention_backward(q, k, v, None, scale, do)
    torch.cuda.synchronize()
    r = {"repeat": all(torch.equal(x, y) for x, y in zip(got, again))}
    if dtype == torch.float32:
        for key, grads in (("err", got), ("old_err", was)):
            errs, plain = cs.k1_f32_errors(grads, q, k, v, None, scale, do)
            r[key + "64"] = max(errs)
            r[key + "_ok"] = cs.k1_f32_holds(errs, plain)
    else:
        for key, grads in (("err", got), ("old_err", was)):
            peak, rms = cs.k1_grad_errors(grads, want)
            r[key], r[key + "_rms"] = max(peak), max(rms)
            r[key + "_ok"] = peak and max(peak) <= cs.K1_BWD_RTOL and \
                max(rms) <= cs.K1_BWD_RMS
    fwd, both = cs.sdpa_grad_calls(q, k, v, None, scale, do)
    r.update(turns({"old": old, "new": new},
                   ("old", "new", "new", "old")))
    r["sdpa"] = cs.graph_ms(both) - cs.graph_ms(fwd)
    r["sdpa_backend"] = cs.sdpa_backend(q, k, v, None, scale)
    r["plain"] = cs.graph_ms(lambda: flash_attention_backward(
        q, k, v, None, scale, do))
    r["bound"], r["bound_by"] = cs.k1_backward_bound(q, k, None)
    r["plan"] = plan_q1_backward(b, h, tk, d, q.element_size())
    if not (r["repeat"] and r["err_ok"]):
        cs.fail(f"single-query backward {name}: {r}")
    cs.say(f"q1 backward {name} B={b} H={h} Tk={tk} D={d} "
           f"{str(dtype)[6:]} plan {r['plan']}: new {r['new']:.4f} ms, "
           f"old {r['old']:.4f}, SDPA's backward ({r['sdpa_backend']}) "
           f"{r['sdpa']:.4f}, plain {r['plain']:.4f}, bound "
           f"{r['bound']:.5f} ({r['bound_by']}); err new "
           f"{r.get('err', r.get('err64')):.3e} old "
           f"{r.get('old_err', r.get('old_err64')):.3e}, repeat "
           f"{r['repeat']} [{cs.CARD}]")
    return r


# -- the statistics -----------------------------------------------------------

def unet_cases():
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2

    with torch.device("meta"):
        unet = NaturalSpeech2(Config()).diff_model.unet
    return cs.resnet_cases(unet)


def gn_inputs(g, b, t, c, film, dtype):
    """x, gamma, beta and FiLM as a model of `dtype` has them: parameters
    in its dtype, FiLM a chunk of one (B, 2C) projection."""
    x = torch.randn(b, t, c, generator=g, device="cuda").to(dtype)
    gamma = (1 + 0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
    beta = (0.1 * torch.randn(c, generator=g, device="cuda")).to(dtype)
    s = sh = None
    if film:
        s, sh = (0.2 * torch.randn(b, 2 * c, generator=g, device="cuda")
                 ).to(dtype).chunk(2, dim=-1)
    return x, gamma, beta, s, sh


def gn_direct(x, gamma, beta, s, sh, splits):
    """A closure launching the port's statistics kernel with `splits`
    blocks per slab (the wrapper plans its own)."""
    from ns2vc_tpu_torch.ops import _build
    from ns2vc_tpu_torch.ops.fused_resnet import gn_threads

    bsz, t, c = x.shape
    lib = _build.library()
    threads = gn_threads(t, c, 8, 16 // x.element_size(), splits)

    def run():
        a, b = (torch.empty(bsz, c, device=x.device) for _ in range(2))
        err = lib.ns2vc_group_norm_affine(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            None if s is None else s.data_ptr(),
            None if sh is None else sh.data_ptr(),
            0 if s is None else s.stride(0), a.data_ptr(), b.data_ptr(),
            None, None, bsz, t, c, 8, 1e-5, splits, threads,
            int(x.dtype == torch.bfloat16),
            int(gamma.dtype == torch.bfloat16), 1,
            torch.cuda.current_stream().cuda_stream)
        if err:
            cs.fail(f"statistics with {splits} splits: CUDA error {err}")
        return a, b
    return run


def gn_sums(old_lib, cases, b, t_scale, dtype, label, splits=(),
            more=None):
    """The statistics kernel, old and new in turns, at every case (and the
    libraries of `more`, name -> library, between them); sums."""
    from ns2vc_tpu_torch.ops.fused_resnet import (
        group_norm_affine, group_norm_affine_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(7)
    tot = defaultdict(float)
    worst = 0.0
    for name, t, c, co, film in cases:
        t = t * t_scale[0] // t_scale[1]
        x, gamma, beta, s, sh = gn_inputs(g, b, t, c, film, dtype)
        args = (x, gamma, beta, 8, 1e-5, s, sh)
        a, bb = group_norm_affine(*args)
        a2, b2 = group_norm_affine(*args)
        pa, pb = group_norm_affine_plain(*args)
        torch.cuda.synchronize()
        err = max((a - pa).abs().max().item(), (bb - pb).abs().max().item())
        tol = cs.GN_RTOL * max(1.0, pa.abs().max().item(),
                               pb.abs().max().item())
        if not (err <= tol and torch.equal(a, a2) and torch.equal(bb, b2)):
            cs.fail(f"statistics {label} {name}: error {err} (tol {tol})")
        worst = max(worst, err / tol * cs.GN_RTOL)

        def new():
            return group_norm_affine(*args)

        def old():
            with using(old_lib):
                return group_norm_affine(*args)
        calls = {"old": old, "new": new}
        for key, lib in (more or {}).items():
            calls[key] = (lambda lib_: lambda: using_call(
                lib_, group_norm_affine, *args))(lib)
        for n in splits:
            calls[f"splits{n}"] = gn_direct(x, gamma, beta, s, sh, n)
        order = ("old", "new", *calls.keys() - {"old", "new"}, "new", "old")
        r = turns(calls, order)
        xf = x.float().view(b, t, 8, c // 8)
        r["var_mean"] = cs.graph_ms(lambda: torch.var_mean(
            xf, dim=(1, 3), correction=0))
        r["bound"] = cs.gn_bound(b, t, c, dtype, gamma.dtype, film)[0]
        for key, ms in r.items():
            tot[key] += ms
    tot = dict(tot, calls=len(cases), worst_rel_err=worst)
    cs.say(f"statistics {label}, {len(cases)} calls: new {tot['new']:.4f} "
           f"ms, old {tot['old']:.4f}, var_mean {tot['var_mean']:.4f}, "
           f"bound {tot['bound']:.5f}"
           + "".join(f", {k} {v:.4f}" for k, v in tot.items()
                     if k.startswith("splits") or k in (more or {}))
           + f"; worst error {worst:.2e} of max(1, |a|, |b|) [{cs.CARD}]")
    return tot


def chain_sums(libs, cases, b, dtype, variants=()):
    """Statistics then the conv at every case, all in one CUDA graph: the
    old kernels, the new, the new without programmatic dependent launch
    (and any statistics variants); the plain versions (the statistics'
    torch ops, then silu(x a + b) and cuDNN's conv in f32) and the library
    chain (the same statistics, then silu(x a + b) and cuDNN's conv in the
    model's dtype)."""
    import torch.nn.functional as F

    from ns2vc_tpu_torch.ops.fused_resnet import (
        affine_silu_conv1d_plain, gn_silu_conv1d, group_norm_affine_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(8)
    ins = []
    for _, t, c, co, film in cases:
        x, gamma, beta, s, sh = gn_inputs(g, b, t, c, film, dtype)
        w = (torch.randn(co, c, 3, generator=g, device="cuda")
             / (3 * c) ** 0.5).to(dtype)
        bias = (0.1 * torch.randn(co, generator=g, device="cuda")).to(dtype)
        ins.append((x, gamma, beta, w, bias, s, sh))

    def chain(lib):
        def run():
            with using(lib):
                return [gn_silu_conv1d(x, gm, bt, w, bs, 8, 1e-5, s, sh)
                        for x, gm, bt, w, bs, s, sh in ins]
        return run
    def plain():
        return [affine_silu_conv1d_plain(
            x, *group_norm_affine_plain(x, gm, bt, 8, 1e-5, s, sh), w, bs)
            for x, gm, bt, w, bs, s, sh in ins]

    def library():
        out = []
        for x, gm, bt, w, bs, s, sh in ins:
            a, bb = group_norm_affine_plain(x, gm, bt, 8, 1e-5, s, sh)
            h = F.silu(x * a[:, None, :].to(x.dtype)
                       + bb[:, None, :].to(x.dtype))
            out.append(F.conv1d(h.transpose(1, 2), w, bs, padding=1)
                       .transpose(1, 2))
        return out
    outs = {k: chain(lib)() for k, lib in (("old", libs["old_gn"]),
                                           ("new", None),
                                           ("no_pdl", libs["no_pdl"]))}
    torch.cuda.synchronize()
    same = all(torch.equal(a, b_) for a, b_ in zip(outs["new"],
                                                   outs["no_pdl"]))
    calls = {"old": chain(libs["old_gn"]), "new": chain(None),
             "no_pdl": chain(libs["no_pdl"]),
             **{name: chain(libs[name]) for name in variants},
             "plain": plain, "library": library}
    r = turns(calls, ("old", "new", "no_pdl", *variants, "plain", "library",
                      "library", "plain", *variants, "no_pdl", "new", "old"))
    r["pdl_equal_no_pdl"] = same
    cs.say(f"chain statistics + K2 conv, {len(cases)} geometries B={b} "
           f"{str(dtype)[6:]}, one graph: new {r['new']:.4f} ms, new "
           f"without PDL {r['no_pdl']:.4f}, old {r['old']:.4f}, plain "
           f"{r['plain']:.4f}, library {r['library']:.4f}"
           + "".join(f", {name} {r[name]:.4f}" for name in variants)
           + f"; new and no-PDL outputs equal: {same} [{cs.CARD}]")
    return r


def serving_turns(old_lib, rounds=2):
    """Wall ms of serving replays (B = 16 and B = 1, bf16, 50 UniPC
    steps): the old kernels' program against the new one's, in turns."""
    from ns2vc_tpu_torch.config import Config
    from ns2vc_tpu_torch.convert import init_params, init_vocos_params
    from ns2vc_tpu_torch.infer.svc import Svc

    cfg = Config()
    gen = torch.Generator().manual_seed(cs.SEED)
    sd = init_params(cfg, gen)
    vsd = init_vocos_params(gen, hop_length=cfg.data.hop_length)
    r = np.random.default_rng(cs.SEED + 2)
    clips = [(0.1 * r.standard_normal((cs.T_CLIP, 256))).astype(np.float32)
             for _ in range(cs.B)]
    refer = r.standard_normal((cs.TP_REFER, 100)).astype(np.float32)
    svcs = {k: Svc(config=cfg, params=sd, vocos_params=vsd,
                   compute_dtype="bfloat16", device="cuda")
            for k in ("old", "new")}
    out = {}
    for bsz in (cs.B, 1):
        def call(key):
            with using(old_lib if key == "old" else None):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = svcs[key].infer_batch(clips[:bsz], refer,
                                            sampling_timesteps=cs.STEPS,
                                            order=2, output="pcm16")
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3, res
        first = {k: call(k) for k in ("old", "new")}   # capture each
        times = defaultdict(list)
        for _ in range(rounds):
            for k in ("old", "new", "new", "old"):
                times[k].append(call(k)[0])
        same = all(np.array_equal(a, b) for a, b in zip(
            first["old"][1], first["new"][1]))
        out[f"b{bsz}"] = {k: v for k, v in times.items()}
        out[f"b{bsz}"]["audio_equal"] = same
        cs.say(f"serving B={bsz} bf16 replays in turns (wall ms): new "
               f"{times['new']}, old {times['old']}; audio bit for bit "
               f"equal: {same} [{cs.CARD}]")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--old-bwd", required=True)
    p.add_argument("--old-gn", required=True)
    p.add_argument("--old-conv", required=True)
    p.add_argument("--old-conv-f32", required=True)
    p.add_argument("--out")
    p.add_argument("--parts", default="q1,statistics,chain,serving",
                   help="comma-separated parts to run")
    p.add_argument("--launch-floor", action="store_true",
                   help="also time the statistics kernel without its reads "
                        "of x and its merges (`launch_floor_source`)")
    p.add_argument("--gn-variant", action="append", default=[],
                   metavar="NAME=SOURCE",
                   help="another statistics source (the entry's arguments "
                        "unchanged), built with the current convs and timed "
                        "beside the others at B=16 bf16 and in the chain")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("torch_q1_gn_compare: needs a CUDA device", file=sys.stderr)
        return 2
    cs.CARD = cs.card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    variants = dict(v.split("=", 1) for v in a.gn_variant)
    if a.launch_floor:
        variants["floor"] = launch_floor_source()
    libs = build_variants({
        "old_bwd": ([a.old_bwd], []),
        "old_gn": ([a.old_gn, a.old_conv, a.old_conv_f32], []),
        "no_pdl": ([os.path.join(CSRC, s) for s in GN_SOURCES],
                   ["-DNS2VC_PDL=0"]),
        **{name: ([src] + [os.path.join(CSRC, s) for s in GN_SOURCES[1:]],
                  []) for name, src in variants.items()}}, old=("old_gn",))
    parts = set(a.parts.split(","))
    res = {"card": cs.CARD, "q1": {}, "statistics": {}}
    pools = (("ref_enc", 32, 1, 100, torch.bfloat16),
             ("add_embedding", 32, 64, 4, torch.bfloat16),
             ("ref_enc_f32", 2, 1, 100, torch.float32),
             ("add_embedding_f32", 2, 64, 4, torch.float32))
    for name, b, h, d, dtype in pools if "q1" in parts else ():
        res["q1"][name] = q1_case(libs["old_bwd"], name, b, h, 273, d, dtype)
    cases = unet_cases()
    old = libs["old_gn"]
    if "statistics" in parts:
        statistics(res["statistics"], old, libs, cases, variants)
    if "chain" in parts:
        res["chain"] = chain_sums(libs, cases, 16, torch.bfloat16, variants)
    if "serving" in parts:
        res["serving"] = serving_turns(old)
    line = json.dumps({"q1_gn_compare": res})
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


def statistics(out, old, libs, cases, variants=()):
    """The statistics kernel's sums at the step geometries, into out."""
    more = {name: libs[name] for name in ("no_pdl", *variants)}
    out["b16_bf16"] = gn_sums(old, cases, 16, (1, 1), torch.bfloat16,
                              "B=16 bf16", more=more)
    out["b16_f32"] = gn_sums(old, cases, 16, (1, 1), torch.float32,
                             "B=16 f32")
    out["b1_bf16"] = gn_sums(old, cases, 1, (1, 1), torch.bfloat16,
                             "B=1 bf16", splits=(1, 2, 4))
    out["train_bf16"] = gn_sums(old, cases, 32, (272, 448), torch.bfloat16,
                                "training B=32 x 272 bf16")


if __name__ == "__main__":
    sys.exit(main())
