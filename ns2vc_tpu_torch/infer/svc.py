"""Svc: the voice-conversion serving engine, serving subset (counterpart of
ns2vc_tpu/infer/svc.py: `_bucket`, `Svc.infer_from_features`,
`infer_batch`, `infer_batch_async` and the program `_get_infer_fn` builds).

content features (T, 256) + a reference mel (Tp, 100) -> encoders ->
cross-attention K/V precompute -> UniPC over the UNet -> Vocos -> 24 kHz
waveform, optionally quantised to int16 PCM on the device. Inputs are padded
to 64-frame shape buckets and masked by length; outputs are trimmed per
request. The model runs in `compute_dtype`; Vocos runs in f32, as the JAX
Svc's vocoder parameters are never cast.

The audio front end (contentvec, F0, mel, resampling), `slice_inference`,
`RealTimeVC`, the micro-batcher and checkpoint loading are later slices;
weights come in as state dicts (`convert.from_flax` or `convert.init_params`).
"""

from __future__ import annotations

import numpy as np
import torch

from ns2vc_tpu.config import Config
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2, generate_mel
from ns2vc_tpu_torch.models.vocos import vocos_from_state_dict
from ns2vc_tpu_torch.utils.precision import resolve_dtype


def _bucket(n: int, step: int = 64) -> int:
    """Round up to a shape bucket (multiple of `step`, at least one step)."""
    return max(step, -(-n // step) * step)


def to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    """f32 waveform in [-1, 1] -> int16 PCM: clip(round(wav * 32767))."""
    return torch.clamp(torch.round(wav.float() * 32767.0),
                       -32768.0, 32767.0).to(torch.int16)


class Svc:
    def __init__(self, config: Config | None = None,
                 params: dict | None = None,
                 vocos_params: dict | None = None,
                 compute_dtype: str | torch.dtype | None = None,
                 device: str | torch.device | None = None):
        """`params` / `vocos_params` are state dicts of the port's
        NaturalSpeech2 / Vocos; `compute_dtype` 'bfloat16' or 'float32'
        (default); `device` defaults to cuda:0 when a card is present."""
        if params is None or vocos_params is None:
            raise ValueError("Svc needs `params` and `vocos_params` state "
                             "dicts (see ns2vc_tpu_torch.convert)")
        self.cfg = config or Config()
        self.device = torch.device(device if device is not None else
                                   "cuda:0" if torch.cuda.is_available()
                                   else "cpu")
        self.compute_dtype = resolve_dtype(compute_dtype)
        self.hop_size = self.cfg.data.hop_length
        self.model = NaturalSpeech2(self.cfg)
        self.model.load_state_dict(params)
        self.model.to(self.device, self.compute_dtype).eval()
        self.vocos = vocos_from_state_dict(vocos_params, self.hop_size)
        self.vocos.load_state_dict(vocos_params)
        self.vocos.to(self.device, torch.float32).eval()

    @torch.no_grad()
    def _run(self, c_in: np.ndarray, r_in: np.ndarray, t_lens, tp_lens,
             sample_method: str, steps: int, order: int, seed: int,
             output: str) -> torch.Tensor:
        """The device program: generate_mel + Vocos (+ pcm16). Returns the
        padded (B, T_pad*hop) waveform on the device, enqueued."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        mel = generate_mel(
            self.model, torch.from_numpy(c_in).to(dev),
            torch.from_numpy(r_in).to(dev),
            torch.as_tensor(t_lens, device=dev),
            torch.as_tensor(tp_lens, device=dev), generator=gen,
            method=sample_method, steps=steps, order=order)
        wav = self.vocos(mel)
        return to_pcm16(wav) if output == "pcm16" else wav

    def infer_from_features(self, c: np.ndarray, refer_mel: np.ndarray,
                            sample_method: str = "unipc",
                            sampling_timesteps: int = 30, seed: int = 0,
                            order: int = 2) -> np.ndarray:
        """content (T, 256) + refer mel (Tp, 100) -> f32 waveform (T*hop,)."""
        t_len, tp_len = c.shape[0], refer_mel.shape[0]
        c_in = np.zeros((1, _bucket(t_len), c.shape[1]), np.float32)
        c_in[0, :t_len] = c
        r_in = np.zeros((1, _bucket(tp_len), refer_mel.shape[1]), np.float32)
        r_in[0, :tp_len] = refer_mel
        wav = self._run(c_in, r_in, [t_len], [tp_len], sample_method,
                        sampling_timesteps, order, seed, "float32")
        return wav[0, : t_len * self.hop_size].cpu().numpy()

    def infer_batch(self, clips: list, refer_mel: np.ndarray,
                    sample_method: str = "unipc",
                    sampling_timesteps: int = 30, seed: int = 0,
                    order: int = 2, output: str = "float32") -> list:
        """Convert many clips in one device batch: a list of (T_i, 256)
        content arrays -> a list of waveforms (float32, or int16 PCM with
        output='pcm16', quantised on the device). All clips are padded to
        the largest bucket and masked by length."""
        return self.infer_batch_async(
            clips, refer_mel, sample_method=sample_method,
            sampling_timesteps=sampling_timesteps, seed=seed, order=order,
            output=output)()

    def infer_batch_async(self, clips: list, refer_mel: np.ndarray,
                          sample_method: str = "unipc",
                          sampling_timesteps: int = 30, seed: int = 0,
                          order: int = 2, output: str = "float32"):
        """infer_batch split at the device/host boundary: enqueues the
        device work (CUDA launches are asynchronous) and returns a zero-arg
        `finish() -> list[np.ndarray]` that blocks on the readback."""
        if not clips:
            return lambda: []
        if output not in ("float32", "pcm16"):
            raise ValueError(f"output must be 'float32'|'pcm16', "
                             f"got {output!r}")
        t_lens = [c.shape[0] for c in clips]
        n, tp_len = len(clips), refer_mel.shape[0]
        c_in = np.zeros((n, _bucket(max(t_lens)), clips[0].shape[1]),
                        np.float32)
        for i, c in enumerate(clips):
            c_in[i, : t_lens[i]] = c
        r_in = np.zeros((n, _bucket(tp_len), refer_mel.shape[1]), np.float32)
        r_in[:, :tp_len] = refer_mel[None]
        wav = self._run(c_in, r_in, t_lens, [tp_len] * n, sample_method,
                        sampling_timesteps, order, seed, output)
        hop = self.hop_size

        def finish() -> list:
            w = wav.cpu().numpy()  # the host sync: device-to-host readback
            return [w[i, : t_lens[i] * hop] for i in range(n)]

        return finish
