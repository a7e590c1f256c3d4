# The port's copy of ns2vc_tpu/config.py: the port imports nothing of the JAX package.
"""Configuration system.

JSON config with the same section layout as the reference `config.json`
(reference utils.py:397-444 `HParams`, model.py:755), expressed as typed
dataclasses.  Hyperparameters that the reference hard-codes at call sites
(UNet topology, model.py:391-400; sampler steps, model.py:644/678; mel
params, preprocess.py:50-57) are first-class fields here.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # reference config.json:2-19
    train_batch_size: int = 32
    gradient_accumulate_every: int = 1
    train_lr: float = 1e-4
    train_num_steps: int = 1_000_000
    adam_betas: Tuple[float, float] = (0.9, 0.99)
    ema_update_every: int = 10
    ema_decay: float = 0.995
    use_ema: bool = False    # reference config carries EMA fields its
                             # Trainer never applies (config.json:8-9);
                             # opt in here to actually maintain EMA params
    save_and_sample_every: int = 1000
    timesteps: int = 1000
    sampling_timesteps: int = 1000
    logs_folder: str = "logs/vc"
    eps: float = 1e-9
    keep_ckpts: int = 3
    num_workers: int = -1  # loader processes; -1 = auto (0 on <=2-CPU
                           # hosts where the pool loses to serial loading
                           # — measured — else 8); explicit values are
                           # honored as-is
    all_in_mem: bool = False
    # reference NaturalSpeech2 constructor options (model.py:446-449,
    # 493-498): clamp the SNR loss weight at min_snr_gamma when enabled
    min_snr_loss_weight: bool = False
    min_snr_gamma: float = 5.0
    # TPU-native additions
    seed: int = 0
    grad_clip_norm: float = 1.0          # reference model.py:871
    compute_dtype: str = "bfloat16"       # MXU-native; "float32" for debugging
    remat: bool = True                    # jax.checkpoint on UNet blocks
    # checkpoint policy when remat is on: "all" recomputes everything in
    # the backward pass (min memory); "dots" saves matmul/conv outputs
    # (jax.checkpoint_policies.dots_with_no_batch_dims_saveable) so the
    # MXU work is never recomputed — more memory, fewer backward FLOPs.
    # Default "dots": measured on v5e at the production config (101M
    # params, batch 32 x 272, bf16) it steps in 62.5 ms vs 74.7 ms for
    # "all" (1.20x) and matches remat-off speed (62.9 ms) at lower
    # memory (scripts/bench_training.py --remat {all,dots,off}).
    remat_policy: str = "dots"
    log_every: int = 100                  # reference model.py:882
    # fixed-shape padded batch geometry (XLA wants few shapes; the reference
    # pads per-batch to max+1, dataset.py:148-153)
    max_content_frames: int = 272         # >= ceil(400*2/3)+1, divisible by 8
    max_refer_frames: int = 272           # >= ceil(400*2/3)+1, divisible by 8
    # length-bucketed batching (SURVEY §7.1.6): ascending CONTENT frame
    # buckets, each divisible by 8 (UNet T constraint). () = single fixed
    # geometry. Items are grouped by bucket and each batch is padded to
    # its bucket instead of always max_content_frames — device step time
    # scales with the content T (the UNet runs over it), so short-item
    # batches run on smaller compiled programs. Each distinct geometry
    # compiles its own train-step program AND program alternation has a
    # measured cost (~3 ms/step on v5e when switching nearly every step),
    # so keep the list short.
    length_buckets: Tuple[int, ...] = ()
    # refer-axis buckets. Default () = refer stays at max_refer_frames:
    # the refer axis only feeds the prompt encoder + cross-KV, so
    # shrinking it saves little step time but multiplies the program
    # count (content x refer pairs) and the switching overhead — measured
    # on v5e: full pair-bucketing LOST 5% vs fixed geometry on a
    # 400-frame corpus (64.7 vs 61.4 ms/step) while content-only keeps
    # the content-axis win. Set only for corpora with genuinely short
    # reference prompts.
    refer_length_buckets: Tuple[int, ...] = ()
    prefetch_depth: int = 3               # in-flight H2D batch transfers
    pack_h2d: bool = True                 # one uint8 H2D transfer per batch
                                          # (unpacked in-jit); wins on
                                          # high-latency hosts, free on DMA


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # reference config.json:21-26
    training_files: str = "dataset_processed"
    val_files: str = "dataset_processed"
    sampling_rate: int = 24000
    hop_length: int = 256
    # mel geometry (reference preprocess.py:50-57)
    n_fft: int = 1024
    win_length: int = 1024
    n_mels: int = 100
    content_sr: int = 16000               # HuBERT input rate (preprocess.py:30)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    # reference config.json:28-33 / 44-49 and model.py:98-190
    in_channels: int = 256
    hidden_channels: int = 256
    out_channels: int = 256
    n_layers: int = 6
    p_dropout: float = 0.2
    n_heads: int = 8                      # op id 8, operations.py:961
    ffn_kernel: int = 9                   # op id 8, operations.py:963
    last_ln: bool = True


@dataclasses.dataclass(frozen=True)
class F0PredictorConfig:
    # reference config.json:34-42 (disabled in VC, model.py:334-335; kept for
    # the TTS-branch capability surface). enabled=True activates the
    # reference's commented-out design (model.py:349-356, 728-731):
    # L1 loss on normalized log-F0 + quantized-F0 embedding added to content.
    enabled: bool = False
    in_channels: int = 256
    hidden_channels: int = 256
    out_channels: int = 1
    attention_layers: int = 10
    n_heads: int = 8
    p_dropout: float = 0.5


@dataclasses.dataclass(frozen=True)
class DiffusionEncoderConfig:
    # reference config.json:50-56 + hard-coded UNet topology model.py:391-400
    in_channels: int = 100
    out_channels: int = 100
    hidden_channels: int = 256
    n_heads: int = 8
    p_dropout: float = 0.2
    block_out_channels: Tuple[int, ...] = (128, 256, 384, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 8
    addition_embed_heads: int = 64        # unet_1d_condition.py:204 default


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout. The reference is DP-only (model.py:756-757);
    we additionally support tensor sharding of the wide UNet levels."""
    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    phoneme_encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    prompt_encoder: EncoderConfig = dataclasses.field(
        default_factory=lambda: EncoderConfig(in_channels=100))
    f0_predictor: F0PredictorConfig = dataclasses.field(default_factory=F0PredictorConfig)
    diffusion_encoder: DiffusionEncoderConfig = dataclasses.field(
        default_factory=DiffusionEncoderConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)


def _update_dataclass(dc, overrides: dict):
    """Recursively apply a (possibly partial) dict of overrides to a frozen
    dataclass, ignoring unknown keys (the reference tolerates extra config
    entries the same way, utils.py:438-444)."""
    field_names = {f.name: f for f in dataclasses.fields(dc)}
    kwargs: dict[str, Any] = {}
    for key, value in overrides.items():
        if key not in field_names:
            continue
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _update_dataclass(current, value)
        elif isinstance(current, tuple) and isinstance(value, Sequence):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return dataclasses.replace(dc, **kwargs)


def load_config(path: str | None = None) -> Config:
    """Load a Config, optionally overriding defaults from a JSON file that
    uses the reference's section layout (config.json:1-56)."""
    cfg = Config()
    if path is not None:
        with open(path) as f:
            raw = json.load(f)
        cfg = _update_dataclass(cfg, raw)
    return cfg


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
