"""Svc: the voice-conversion inference engine (counterpart of
ns2vc_tpu/infer/svc.py).

wav in -> resample (24 kHz for F0, 16 kHz for ContentVec) -> F0 (the AC
tracker on the host by default, DIO when it fails, CREPE on the device
under `f0_mean_pooling`) and ContentVec content features -> the reference
clip's log-mel -> encoders -> cross-attention K/V precompute -> sampler
over the UNet -> Vocos -> 24 kHz waveform, optionally quantised to int16
PCM on the device.

Inputs are padded to 64-frame shape buckets and masked by length; outputs
are trimmed per request. The diffusion model runs in `compute_dtype`;
ContentVec, CREPE and Vocos run in f32, as in the JAX Svc.

The device part of a call (encoders, the step-invariant conditioning
precompute, the sampler loop over the UNet, Vocos, and the int16
quantisation) is one serving program per key, as the JAX Svc's
`_get_infer_fn` jits one XLA program per key. The key is the JAX key
(method, steps, order, use_f0, auto_predict_f0, vocode, output) with DDIM's
eta, what JAX's retracing keys (the padded batch and the 64-frame T and Tp
buckets), the compute dtype and the float32 matmul and cuDNN TF32 settings
in force (a capture bakes them in). A program reads its inputs from static
device buffers that each call fills: the content, refer, lengths, f0 and
uv, and the randomness, drawn before the device work from the call's
seeded generator in the order the eager body draws it (x_T, then each
DDPM or DDIM eta > 0 step's noise), so a call at seed s gives the eager
body's result at seed s. On a card the program's first call runs the body
eagerly once (the warm-up), captures it as a CUDA graph and replays it;
every later call at the key only replays (`utils/graphs.py`: the side
stream, the thread-local capture mode, the memory pool the Svc's graphs
share, the launch counts a replay adds). Replays are serialised under the
Svc's lock and each output is copied out, in stream order, before the
next replay. A failed capture or replay raises; nothing falls back to
eager on a card. On the CPU the program runs its body eagerly over the
same static buffers and pre-drawn noise. `unload_model` drops the
programs.

Dispatch and readback are split (`infer_batch_async`): the device work is
enqueued on the Svc's card's current stream with pinned, non-blocking
uploads, the waveform's device-to-host copy is enqueued into pinned memory
behind it, and a CUDA event recorded on that stream after the copy is all
`finish()` waits on. So a caller can dispatch batch N+1 while batch N's
readback is outstanding, as the MicroBatcher does.

The device is 'cuda' unless `device` says otherwise, resolved to an indexed
card at construction; every device call runs with that card current, so a
thread whose own current device differs (the MicroBatcher's worker) reaches
the same card and stream. Without a card the constructor raises instead of
running on the CPU.

A checkpoint with `f0_predictor.enabled` is conditioned on the source F0:
every inference call must pass f0 (and uv; without uv the frames count as
unvoiced), else ValueError, as in the JAX Svc; `auto_predict_f0` makes the
F0 embedding take the predicted contour instead of the given one. f0/uv are
uploaded in f32 whatever the compute dtype. Without the predictor, f0/uv
are ignored.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ns2vc_tpu_torch.config import Config, load_config
from ns2vc_tpu_torch.audio.host import (
    compute_f0_ac, compute_f0_dio, interpolate_f0, read_wav, repeat_expand_2d,
)
from ns2vc_tpu_torch.audio.mel import log_mel_spectrogram
from ns2vc_tpu_torch.audio.resample import resample
from ns2vc_tpu_torch.diffusion.samplers import noise_calls
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2, generate_mel
from ns2vc_tpu_torch.models.vocos import vocos_from_state_dict
from ns2vc_tpu_torch.utils.graphs import GraphCapturer, GraphProgram
from ns2vc_tpu_torch.utils.precision import resolve_dtype


class F0FilterException(Exception):
    """No voice detected."""


def _bucket(n: int, step: int = 64) -> int:
    """Round up to a shape bucket (multiple of `step`, at least one step)."""
    return max(step, -(-n // step) * step)


def to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    """f32 waveform in [-1, 1] -> int16 PCM: clip(round(wav * 32767))."""
    return torch.clamp(torch.round(wav.float() * 32767.0),
                       -32768.0, 32767.0).to(torch.int16)


class _ProgramKey(NamedTuple):
    """What one serving program is for: the JAX Svc's `_get_infer_fn` key
    and DDIM's eta, the shapes JAX's retracing keys, and what a capture
    bakes in."""
    method: str
    steps: int
    order: int
    use_f0: bool
    auto_predict_f0: bool
    vocode: bool
    output: str
    eta: float
    batch: int
    t_pad: int
    tp_pad: int
    dtype: torch.dtype
    tf32_matmul: bool
    tf32_cudnn: bool


def resolve_device(device: str | torch.device) -> torch.device:
    """A torch.device; 'cuda' without an index becomes the current card, so
    the device does not depend on which thread later uses it. A CUDA device
    without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: no CUDA device is "
                               f"available; pass device='cpu' to run on the "
                               f"CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Svc:
    def __init__(self, net_g_path: Optional[str] = None,
                 config_path: Optional[str] = None,
                 contentvec_ckpt: str = "hubert/checkpoint_best_legacy_500.pt",
                 vocos_ckpt: Optional[str] = None,
                 crepe_ckpt: str = "crepe/full.pth",
                 config: Optional[Config] = None,
                 params: Optional[dict] = None,
                 contentvec_params: Optional[dict] = None,
                 vocos_params: Optional[dict] = None,
                 crepe_params: Optional[dict] = None,
                 compute_dtype: str | torch.dtype | None = None,
                 device: str | torch.device = "cuda",
                 use_ema_params: bool = True):
        """The JAX Svc's keywords, with port state dicts for `params`,
        `contentvec_params`, `vocos_params` and `crepe_params` (see
        ns2vc_tpu_torch.convert). `net_g_path` is a reference `model-N.pt`
        or a port state dict saved with torch.save; the checkpoint paths
        are the public fairseq contentvec, charactr/vocos and torchcrepe
        files. `compute_dtype` 'bfloat16' or 'float32' (default). A
        checkpoint of the port's trainer deploys its EMA parameters when it
        holds them, unless `use_ema_params` is False."""
        from ns2vc_tpu_torch.convert import load_checkpoint
        from ns2vc_tpu_torch.features.contentvec import (
            contentvec_from_state_dict, load_contentvec,
        )
        from ns2vc_tpu_torch.features.crepe import crepe_from_state_dict
        from ns2vc_tpu_torch.models.vocos import load_vocos

        self.cfg = config or load_config(config_path)
        self.device = resolve_device(device)
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.target_sample = self.cfg.data.sampling_rate
        self.hop_size = self.cfg.data.hop_length
        if params is None:
            if net_g_path is None:
                raise ValueError("Svc needs either `net_g_path` or `params`")
            params = load_checkpoint(net_g_path, self.cfg,
                                     use_ema=use_ema_params)
        self.model = NaturalSpeech2(self.cfg)
        self.model.load_state_dict(params)
        self.model.to(self.device, self.compute_dtype).eval()
        self._refer_cache: dict = {}  # (key, n, tp_pad) -> device tensor
        # a program's static buffers: "noise" lists each call's pre-drawn
        # noise (None where the sampler draws none), "draws" the same
        # buffers in draw order
        self._programs: dict[_ProgramKey, GraphProgram] = {}
        self._graphs = GraphCapturer(self.device)
        # one call's copy in, replay and copy out at a time
        self._serving_lock = threading.Lock()
        self._last_readback: Optional[torch.cuda.Event] = None

        def place(module):
            return None if module is None else \
                module.to(self.device, torch.float32).eval()

        self.contentvec = place(
            contentvec_from_state_dict(contentvec_params)
            if contentvec_params is not None else
            load_contentvec(contentvec_ckpt)
            if contentvec_ckpt and os.path.exists(contentvec_ckpt) else None)
        vocos = None
        if vocos_params is not None:
            vocos = vocos_from_state_dict(vocos_params, self.hop_size)
            vocos.load_state_dict(vocos_params)
        elif vocos_ckpt and os.path.exists(vocos_ckpt):
            vocos = load_vocos(vocos_ckpt, hop_length=self.hop_size)
        self.vocos = place(vocos)
        self.crepe = place(None if crepe_params is None
                           else crepe_from_state_dict(crepe_params))
        self._crepe_ckpt = crepe_ckpt

    def _load_crepe(self):
        if self.crepe is None:
            if not os.path.exists(self._crepe_ckpt):
                raise RuntimeError(
                    f"F0_mean_pooling needs CREPE weights at "
                    f"{self._crepe_ckpt!r} (torchcrepe's full.pth), or pass "
                    f"crepe_params to Svc")
            from ns2vc_tpu_torch.features.crepe import load_crepe

            self.crepe = load_crepe(self._crepe_ckpt).to(self.device).eval()
        return self.crepe

    def _on_device(self):
        """This Svc's card as the calling thread's current device: the
        kernels launch on the current device's stream, and the readback
        event must be recorded on the stream the copy went to."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    # -- feature extraction -------------------------------------------------

    def compute_f0(self, wav24: np.ndarray, tran: int = 0,
                   f0_mean_pooling: bool = False,
                   cr_threshold: float = 0.05,
                   f0_filter: bool = False):
        """F0 at the mel frame rate -> (f0, uv), transposed by `tran`
        semitones: the AC tracker by default, DIO if it raises, CREPE
        under f0_mean_pooling."""
        if f0_mean_pooling:
            from ns2vc_tpu_torch.features.crepe import compute_f0_uv_crepe

            with self._on_device():
                f0, uv = compute_f0_uv_crepe(
                    wav24, sampling_rate=self.target_sample,
                    hop_length=self.hop_size, threshold=cr_threshold,
                    model=self._load_crepe())
        else:
            try:
                f0 = compute_f0_ac(wav24, sampling_rate=self.target_sample,
                                   hop_length=self.hop_size)
            except Exception:
                f0 = compute_f0_dio(wav24, sampling_rate=self.target_sample,
                                    hop_length=self.hop_size)
            f0, uv = interpolate_f0(f0)
        if f0_filter and float(np.sum(f0)) == 0.0:
            raise F0FilterException("No voice detected")
        return f0 * 2 ** (tran / 12), uv

    @torch.no_grad()
    def compute_features(self, wav: np.ndarray, sr: int, tran: int = 0,
                         f0_mean_pooling: bool = False,
                         cr_threshold: float = 0.05,
                         f0_filter: bool = False):
        """source wav -> (content (T, 256), f0, uv, wav24) at the mel frame
        rate. ContentVec is enqueued on the device before the host F0
        runs, so the two overlap on a card."""
        if wav.ndim > 1:
            wav = wav.mean(axis=0)
        if self.contentvec is None:
            raise RuntimeError(
                "contentvec checkpoint missing — cannot extract content")
        with self._on_device():
            x = torch.from_numpy(np.asarray(wav, np.float32)).to(self.device)
            wav24 = resample(x, sr, self.target_sample).cpu().numpy()
            c = self.contentvec(resample(x, sr, 16000)[None])[0]  # (T50, 256)
        f0, uv = self.compute_f0(wav24, tran, f0_mean_pooling, cr_threshold,
                                 f0_filter)
        c = repeat_expand_2d(c.cpu().numpy(), len(f0))
        return c, f0, uv, wav24

    @torch.no_grad()
    def compute_refer_mel(self, refer_wav: np.ndarray, sr: int) -> np.ndarray:
        """reference wav -> its (Tp, 100) log-mel at 24 kHz."""
        if refer_wav.ndim > 1:
            refer_wav = refer_wav.mean(axis=0)
        with self._on_device():
            x = torch.from_numpy(np.asarray(refer_wav, np.float32)).to(
                self.device)
            mel = log_mel_spectrogram(
                resample(x, sr, self.target_sample), self.target_sample,
                self.cfg.data.n_fft, self.hop_size, self.cfg.data.n_mels)
            return mel.T.cpu().numpy()

    # -- the device program ---------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor; on a card through pinned memory
        with a non-blocking copy, so the upload does not wait for earlier
        work on the stream."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _device_refer(self, refer_mel: np.ndarray, n: int, tp_pad: int,
                      cache_key=None) -> torch.Tensor:
        """The padded, batched refer mel on the device in the compute dtype.
        With `cache_key` it is uploaded once per (key, batch, length-bucket)
        geometry; the caller must not mutate refer_mel while reusing a key,
        and drops the key's entries with `drop_refer_cache`."""
        key = None if cache_key is None else (cache_key, n, tp_pad)
        hit = self._refer_cache.get(key) if key is not None else None
        if hit is not None:
            return hit
        r_in = np.zeros((n, tp_pad, refer_mel.shape[1]), np.float32)
        r_in[:, : refer_mel.shape[0]] = refer_mel[None]
        dev = self._upload(r_in).to(self.compute_dtype)
        if key is not None:
            self._refer_cache[key] = dev
        return dev

    def drop_refer_cache(self, cache_key) -> None:
        """Evict every device refer cached under `cache_key`."""
        for key in [k for k in list(self._refer_cache) if k[0] == cache_key]:
            self._refer_cache.pop(key, None)

    @torch.no_grad()
    def _run_eager(self, c_in: np.ndarray, r_dev: torch.Tensor, t_lens,
                   tp_len: int, sample_method: str, steps: int, order: int,
                   seed: int, output: str, f0_in: Optional[np.ndarray] = None,
                   uv_in: Optional[np.ndarray] = None,
                   auto_predict_f0: bool = False,
                   eta: float = 0.0) -> torch.Tensor:
        """The eager body of `_run`: generate_mel (drawing its own noise
        from the seeded generator) + Vocos (+ pcm16), every op dispatched
        from Python. What a program's replay at the same seed must equal."""
        n = c_in.shape[0]
        gen = torch.Generator(device=self.device).manual_seed(seed)
        mel = generate_mel(
            self.model, self._upload(c_in),  r_dev,
            self._upload(np.asarray(t_lens, np.int64)),
            self._upload(np.full((n,), tp_len, np.int64)), generator=gen,
            method=sample_method, steps=steps, order=order,
            f0=None if f0_in is None else self._upload(f0_in),
            uv=None if uv_in is None else self._upload(uv_in),
            auto_predict_f0=auto_predict_f0, eta=eta)
        wav = self.vocos(mel)
        return to_pcm16(wav) if output == "pcm16" else wav

    @torch.no_grad()
    def _run(self, c_in: np.ndarray, r_dev: torch.Tensor, t_lens, tp_len: int,
             sample_method: str, steps: int, order: int, seed: int,
             output: str, f0_in: Optional[np.ndarray] = None,
             uv_in: Optional[np.ndarray] = None,
             auto_predict_f0: bool = False, eta: float = 0.0) -> torch.Tensor:
        """generate_mel + Vocos (+ pcm16) through the serving program of
        this call's key, enqueued on the device: the padded (B, T_pad * hop)
        waveform. On a card it is the program's static output, which the
        next call overwrites: the caller reads it back first, as
        `infer_batch_async` does under the Svc's lock."""
        key = _ProgramKey(
            sample_method, steps, order, f0_in is not None, auto_predict_f0,
            True, output, float(eta), c_in.shape[0], c_in.shape[1],
            r_dev.shape[1], self.compute_dtype,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
        prog = self._programs.get(key)
        new = prog is None
        if new:
            prog = self._new_program(key, c_in.shape[2], r_dev.shape[2])
        self._stage(prog, c_in, r_dev, t_lens, tp_len, seed, f0_in, uv_in)
        if self.device.type != "cuda":
            self._programs[key] = prog
            return self._program_body(prog)
        if new:
            self._capture(prog)
            self._programs[key] = prog
        return prog.replay()

    def _new_program(self, key: _ProgramKey, c_dim: int,
                     mel_dim: int) -> GraphProgram:
        """A program's static buffers, allocated outside any capture."""
        n, t = key.batch, key.t_pad

        def empty(*shape, dtype=self.compute_dtype):
            return torch.empty(shape, dtype=dtype, device=self.device)
        out_ch = self.cfg.diffusion_encoder.out_channels
        calls = noise_calls(key.method, self.model.schedule, key.steps,
                            key.eta)
        draws = list(empty(len(calls), n, t, out_ch)) if calls else []
        noise = None
        if calls:
            noise = [None] * (calls[-1] + 1)
            for j, buf in zip(calls, draws):
                noise[j] = buf
        f0 = empty(n, t, dtype=torch.float32) if key.use_f0 else None
        return GraphProgram(key, {
            "c": empty(n, t, c_dim, dtype=torch.float32),
            "refer": empty(n, key.tp_pad, mel_dim),
            "lengths": empty(n, dtype=torch.int64),
            "refer_lengths": empty(n, dtype=torch.int64),
            "f0": f0, "uv": None if f0 is None else torch.empty_like(f0),
            "x_T": empty(n, t, out_ch), "noise": noise, "draws": draws})

    def _stage(self, prog: GraphProgram, c_in: np.ndarray, r_dev: torch.Tensor,
               t_lens, tp_len: int, seed: int,
               f0_in: Optional[np.ndarray],
               uv_in: Optional[np.ndarray]) -> None:
        """Fill a program's static inputs for one call, enqueued on the
        current stream: the host arrays through pinned memory, the refer
        from the device, x_T and each step's noise drawn from the call's
        seeded generator in the eager body's order."""
        s, on_card = prog.static, self.device.type == "cuda"
        n = c_in.shape[0]
        for name, arr in (("c", c_in), ("lengths", np.asarray(t_lens,
                                                               np.int64)),
                          ("refer_lengths", np.full((n,), tp_len, np.int64)),
                          ("f0", f0_in), ("uv", uv_in)):
            if s[name] is not None:
                src = torch.from_numpy(np.ascontiguousarray(arr))
                s[name].copy_(src.pin_memory() if on_card else src,
                              non_blocking=on_card)
        s["refer"].copy_(r_dev)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for buf in (s["x_T"], *s["draws"]):
            buf.normal_(generator=gen)

    def _program_body(self, prog: GraphProgram) -> torch.Tensor:
        """One call's device work over a program's static buffers: the
        eager body with x_T and the noise given."""
        s, key = prog.static, prog.key
        mel = generate_mel(
            self.model, s["c"], s["refer"], s["lengths"], s["refer_lengths"],
            x_T=s["x_T"], method=key.method, steps=key.steps,
            order=key.order, noise=s["noise"], f0=s["f0"], uv=s["uv"],
            auto_predict_f0=key.auto_predict_f0, eta=key.eta)
        wav = self.vocos(mel)
        return to_pcm16(wav) if key.output == "pcm16" else wav

    def _capture(self, prog: GraphProgram) -> None:
        """A program's first call on a card, before its first replay: the
        body's warm-up and capture (`GraphCapturer.capture`). Raises if the
        capture fails."""
        self._graphs.capture(prog, lambda: self._program_body(prog),
                             "serving program")

    def _program_memory(self) -> dict:
        """Device bytes the program cache holds: its static buffers, and on
        a card the segments of its graphs' memory pool."""
        static = sum(t.numel() * t.element_size()
                     for p in self._programs.values()
                     for name, t in p.static.items()
                     if isinstance(t, torch.Tensor))
        static += sum(d.numel() * d.element_size()
                      for p in self._programs.values()
                      for d in p.static["draws"])
        pools = {tuple(p.graph.pool()) for p in self._programs.values()
                 if p.graph is not None}
        pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) in pools) if pools else 0
        return {"programs": len(self._programs), "static_bytes": static,
                "pool_bytes": pool}

    # -- single-clip inference ----------------------------------------------

    def infer(self, tran: int, raw_path: str, refer_path: str,
              auto_predict_f0: bool = False, f0_filter: bool = False,
              F0_mean_pooling: bool = False, cr_threshold: float = 0.05,
              sample_method: str = "unipc", sampling_timesteps: int = 30,
              seed: int = 0, order: int = 2):
        wav, sr = read_wav(raw_path)
        refer_wav, refer_sr = read_wav(refer_path)
        c, f0, uv, _ = self.compute_features(
            wav, sr, tran, f0_mean_pooling=F0_mean_pooling,
            cr_threshold=cr_threshold, f0_filter=f0_filter)
        refer_mel = self.compute_refer_mel(refer_wav, refer_sr)
        start = time.time()
        audio = self.infer_from_features(
            c, refer_mel, sample_method, sampling_timesteps, seed,
            order=order, f0=f0, uv=uv, auto_predict_f0=auto_predict_f0)
        print(f"ns2vc use time:{time.time() - start}")
        return audio, audio.shape[-1]

    def infer_from_features(self, c: np.ndarray, refer_mel: np.ndarray,
                            sample_method: str = "unipc",
                            sampling_timesteps: int = 30, seed: int = 0,
                            order: int = 2, f0: Optional[np.ndarray] = None,
                            uv: Optional[np.ndarray] = None,
                            auto_predict_f0: bool = False) -> np.ndarray:
        """content (T, 256) + refer mel (Tp, 100) -> f32 waveform (T*hop,)."""
        return self.infer_batch(
            [c], refer_mel, sample_method, sampling_timesteps, seed, order,
            f0s=None if f0 is None else [f0], uvs=None if uv is None else [uv],
            auto_predict_f0=auto_predict_f0)[0]

    def infer_batch(self, clips: list, refer_mel: np.ndarray,
                    sample_method: str = "unipc",
                    sampling_timesteps: int = 30, seed: int = 0,
                    order: int = 2, f0s: Optional[list] = None,
                    uvs: Optional[list] = None,
                    auto_predict_f0: bool = False,
                    output: str = "float32", eta: float = 0.0) -> list:
        """Convert many clips in one device batch: a list of (T_i, 256)
        content arrays -> a list of waveforms (float32, or int16 PCM with
        output='pcm16', quantised on the device). All clips are padded to
        the largest bucket and masked by length. `eta` is DDIM's (0, the
        JAX Svc's, is deterministic)."""
        return self.infer_batch_async(
            clips, refer_mel, sample_method=sample_method,
            sampling_timesteps=sampling_timesteps, seed=seed, order=order,
            f0s=f0s, uvs=uvs, auto_predict_f0=auto_predict_f0,
            output=output, eta=eta)()

    def infer_batch_async(self, clips: list, refer_mel: np.ndarray,
                          sample_method: str = "unipc",
                          sampling_timesteps: int = 30, seed: int = 0,
                          order: int = 2, f0s: Optional[list] = None,
                          uvs: Optional[list] = None,
                          auto_predict_f0: bool = False,
                          output: str = "float32", refer_cache_key=None,
                          eta: float = 0.0):
        """infer_batch split at the device/host boundary: enqueues the
        device work (the serving program of the call's key) and the
        readback into pinned memory, and returns a zero-arg `finish() ->
        list[np.ndarray]` that waits on this batch's own CUDA event
        (`finish.done`) and nothing else. A `refer_cache_key` keeps the
        padded refer on the device across dispatches. Safe to call from
        several threads: one call's copy in, replay and copy out hold the
        Svc's lock, and a call on another stream waits for the previous
        call's readback before it fills the static inputs."""
        if not clips:
            return lambda: []
        if output not in ("float32", "pcm16"):
            raise ValueError(f"output must be 'float32'|'pcm16', "
                             f"got {output!r}")
        if self.vocos is None:
            raise RuntimeError("vocos checkpoint missing — cannot vocode")
        if f0s is not None and len(f0s) != len(clips):
            raise ValueError(f"{len(f0s)} f0 arrays for {len(clips)} clips")
        use_f0 = self.cfg.f0_predictor.enabled
        if use_f0 and f0s is None:
            raise ValueError(
                "this checkpoint has f0_predictor.enabled: pass per-clip f0s "
                "(and uvs), e.g. from Svc.compute_features, on every "
                "inference call; auto_predict_f0 only switches the embedding "
                "to the predicted contour, the predictor still reads the "
                "source f0")
        t_lens = [c.shape[0] for c in clips]
        n, t_pad, hop = len(clips), _bucket(max(t_lens)), self.hop_size
        c_in = np.zeros((n, t_pad, clips[0].shape[1]), np.float32)
        for i, c in enumerate(clips):
            c_in[i, : t_lens[i]] = c
        f0_in = uv_in = None
        if use_f0:
            f0_in = np.zeros((n, t_pad), np.float32)
            uv_in = np.zeros((n, t_pad), np.float32)
            for i in range(n):
                m = min(t_lens[i], len(f0s[i]))
                f0_in[i, :m] = f0s[i][:m]
                if uvs is not None and uvs[i] is not None:
                    uv_in[i, :m] = uvs[i][:m]
        dtype = torch.int16 if output == "pcm16" else torch.float32
        on_card = self.device.type == "cuda"
        done = None
        with self._on_device(), self._serving_lock:
            # the pinned readback buffer is allocated before any of this
            # batch's work is enqueued
            host = torch.empty((n, t_pad * hop), dtype=dtype,
                               pin_memory=on_card)
            r_dev = self._device_refer(refer_mel, n,
                                       _bucket(refer_mel.shape[0]),
                                       cache_key=refer_cache_key)
            stream = torch.cuda.current_stream(self.device) if on_card \
                else None
            if self._last_readback is not None:
                stream.wait_event(self._last_readback)
            wav = self._run(c_in, r_dev, t_lens, refer_mel.shape[0],
                            sample_method, sampling_timesteps, order, seed,
                            output, f0_in, uv_in, auto_predict_f0, eta)
            host.copy_(wav, non_blocking=on_card)
            if on_card:
                done = torch.cuda.Event()
                done.record(stream)
                self._last_readback = done

        def finish() -> list:
            if done is not None:
                done.synchronize()  # this batch's readback, nothing later
            w = host.numpy()
            return [w[i, : t_lens[i] * hop].copy() for i in range(n)]

        finish.done = done
        return finish

    # -- sliced long-form inference -------------------------------------------

    def slice_inference(self, raw_audio_path: str, refer_path: str,
                        tran: int = 0, slice_db: float = -40,
                        pad_seconds: float = 0.5,
                        sample_method: str = "unipc",
                        sampling_timesteps: int = 30,
                        clip_seconds: float = 0, lg_seconds: float = 0,
                        lgr: float = 0.75, order: int = 2,
                        auto_predict_f0: bool = False,
                        f0_mean_pooling: bool = False,
                        cr_threshold: float = 0.05,
                        max_batch: int = 16) -> np.ndarray:
        """Long-form conversion in three passes: host feature extraction
        per chunk, one batched device dispatch per (length bucket,
        <= max_batch) group, then silence/crossfade assembly."""
        from ns2vc_tpu_torch.audio.host import Slicer
        from ns2vc_tpu_torch.infer.cli import crossfade_concat

        wav, sr = read_wav(raw_audio_path)
        if wav.ndim > 1:
            wav = wav.mean(axis=0)
        chunks = Slicer(sr=sr, threshold=slice_db).slice(wav)
        refer_wav, refer_sr = read_wav(refer_path)
        refer_mel = self.compute_refer_mel(refer_wav, refer_sr)
        pad_frames = int(pad_seconds * self.target_sample)

        # -- pass 1 (host): features per convertible clip + assembly plan
        jobs: list[dict] = []

        def stage_clip(data: np.ndarray) -> int:
            length = int(np.ceil(len(data) / sr * self.target_sample))
            pad = int(pad_seconds * sr)
            padded = np.concatenate([np.zeros(pad, np.float32), data,
                                     np.zeros(pad, np.float32)])
            c, f0, uv, _ = self.compute_features(
                padded, sr, tran, f0_mean_pooling=f0_mean_pooling,
                cr_threshold=cr_threshold)
            jobs.append({"c": c, "f0": f0, "uv": uv, "length": length})
            return len(jobs) - 1

        plan: list[tuple] = []
        for v in dict(chunks).values():
            start, end = (int(x) for x in v["split_time"].split(","))
            if start == end:
                continue
            data = wav[start:end]
            length = int(np.ceil(len(data) / sr * self.target_sample))
            if v["slice"]:  # silence: passthrough zeros
                plan.append(("silence", length))
            elif clip_seconds > 0 and len(data) > clip_seconds * sr:
                # forced clipping: consecutive clips overlap by lg and are
                # crossfaded with lgr retention
                n = int(clip_seconds * sr)
                lg_src = int(lg_seconds * sr)
                lg = int(lg_seconds * self.target_sample)
                idxs = [stage_clip(data[(i - lg_src if i - lg_src >= 0
                                         else i): i + n])
                        for i in range(0, len(data), n)]
                plan.append(("crossfade", idxs, lg, length))
            else:
                plan.append(("clip", stage_clip(data)))

        # -- pass 2 (device): batch by content-length bucket
        outs: list = [None] * len(jobs)
        by_bucket: dict[int, list[int]] = {}
        for i, j in enumerate(jobs):
            by_bucket.setdefault(_bucket(j["c"].shape[0]), []).append(i)
        for b in sorted(by_bucket):
            idxs = by_bucket[b]
            for k in range(0, len(idxs), max_batch):
                grp = idxs[k: k + max_batch]
                res = self.infer_batch(
                    [jobs[i]["c"] for i in grp], refer_mel,
                    sample_method=sample_method,
                    sampling_timesteps=sampling_timesteps, order=order,
                    f0s=[jobs[i]["f0"] for i in grp],
                    uvs=[jobs[i]["uv"] for i in grp],
                    auto_predict_f0=auto_predict_f0)
                for i, out in zip(grp, res):
                    outs[i] = out[pad_frames: pad_frames
                                  + jobs[i]["length"]].astype(np.float32)

        # -- pass 3 (host): reassemble silence / clips / crossfades in order
        pieces = []
        for item in plan:
            if item[0] == "silence":
                pieces.append(np.zeros(item[1], np.float32))
            elif item[0] == "clip":
                pieces.append(outs[item[1]])
            else:
                _, idxs, lg, length = item
                pieces.append(crossfade_concat([outs[i] for i in idxs], lg,
                                               retain=lgr)[:length])
        return np.concatenate(pieces) if pieces else np.zeros(0, np.float32)

    def clear_empty(self):
        """Return the card's cached memory blocks to the driver (the
        reference's clear_empty, infer_tool.py:246-249); nothing on the
        CPU."""
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def unload_model(self):
        """Drop the model, the refer cache and the serving programs (their
        graphs and memory pool), as the JAX Svc drops its jit cache."""
        with self._serving_lock:
            self.model = None
            self._refer_cache.clear()
            self._programs.clear()
            self._graphs.reset()
            self._last_readback = None


class RealTimeVC:
    """Streaming chunker with a crossfade between consecutive outputs."""

    def __init__(self, svc: Svc, chunk_seconds: float = 2.0,
                 crossfade_seconds: float = 0.05):
        self.svc = svc
        self.chunk_len = int(chunk_seconds * svc.target_sample)
        self.pre_len = int(crossfade_seconds * svc.target_sample)
        self.pre_len = (self.pre_len // svc.hop_size) * svc.hop_size
        self.last_tail: Optional[np.ndarray] = None

    def process(self, wav_chunk: np.ndarray, sr: int, refer_mel: np.ndarray,
                tran: int = 0, sample_method: str = "unipc",
                sampling_timesteps: int = 30,
                auto_predict_f0: bool = False,
                f0_mean_pooling: bool = False,
                cr_threshold: float = 0.05) -> np.ndarray:
        """Convert one streaming chunk and crossfade its head into the
        previous chunk's tail."""
        c, f0, uv, _ = self.svc.compute_features(
            wav_chunk, sr, tran, f0_mean_pooling=f0_mean_pooling,
            cr_threshold=cr_threshold)
        out = np.array(self.svc.infer_from_features(
            c, refer_mel, sample_method, sampling_timesteps,
            f0=f0, uv=uv, auto_predict_f0=auto_predict_f0))
        if self.last_tail is not None and self.pre_len > 0:
            n = min(self.pre_len, len(out), len(self.last_tail))
            ramp = np.linspace(0.0, 1.0, n, dtype=np.float32)
            out[:n] = self.last_tail[-n:] * (1 - ramp) + out[:n] * ramp
        if self.pre_len > 0:
            self.last_tail = out[-self.pre_len:].copy()
        return out
