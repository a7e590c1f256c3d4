# The port's copy of ns2vc_tpu/utils/convert_reference.py: the port imports nothing of the JAX package.
"""Convert reference (adelacvg/NS2VC, PyTorch) weights to this framework.

The port keeps every converter of the JAX module: `TrackedStateDict` and
`assert_fully_consumed` (its strict public-layout loaders),
`natural_speech2` with the helpers it reaches, whose flax-layout tree
`convert.from_flax` turns into the port's state dict, the helpers of the
reference's other modules (`mha_cross`, `new_conv_ffn`,
`dual_transformer_1d`) and `load_reference_checkpoint`.

Two uses:
1. parity tests: instantiate a reference torch module with random weights,
   convert, and assert the JAX forward matches;
2. migration: load an author-trained `model-{N}.pt` (reference
   model.py:812-815 saves `{'step', 'model'}`) into the JAX model.

Layout notes:
- reference encoders run (T, B, C) with ConvTBC whose weight is already
  (K, C_in, C_out) — identical to flax nn.Conv kernels;
- torch nn.Conv1d weights are (C_out, C_in, K) -> transpose to (K, C_in, C_out);
- torch nn.Linear weights are (out, in) -> transpose;
- fairseq MultiheadAttention packs qkv as in_proj_weight (3C, C)
  (reference operations.py:327) -> DenseGeneral kernel (C, 3, C).

Only torch is required (CPU); all functions accept a flat
`state_dict`-style mapping of numpy arrays or torch tensors.
"""

from __future__ import annotations

import re

import numpy as np


class TrackedStateDict(dict):
    """A state-dict wrapper that records which keys a converter consumed,
    so `assert_fully_consumed` can fail LOUDLY on source-layout drift
    (VERDICT round-2 #9: a renamed key in a real fairseq/vocos checkpoint
    must not be silently dropped)."""

    def __init__(self, sd):
        super().__init__(sd)
        self.accessed: set = set()

    def __getitem__(self, key):
        self.accessed.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        if super().__contains__(key):
            return self[key]
        return default

    def unconsumed(self, ignore: tuple = ()) -> list:
        pats = [re.compile(p) for p in ignore]
        return sorted(
            k for k in self if k not in self.accessed
            and not any(p.fullmatch(k) for p in pats))


def assert_fully_consumed(sd: TrackedStateDict, ignore: tuple = (),
                          context: str = "") -> None:
    """Raise if the converter left any source key unconsumed (modulo the
    `ignore` regexes, which cover non-parameter buffers the target
    recomputes from config). The converse direction — every target param
    written — is enforced by flax itself: `module.apply` raises on a
    missing parameter collection entry."""
    leftover = sd.unconsumed(ignore)
    if leftover:
        raise ValueError(
            f"{context or 'converter'}: {len(leftover)} source state-dict "
            f"key(s) not consumed — source layout drift? First few: "
            f"{leftover[:8]}")


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def _j(p: str, name: str) -> str:
    return f"{p}.{name}" if p else name


def linear(sd, p, bias=True):
    out = {"kernel": _np(sd[f"{p}.weight"]).T}
    if bias:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


def layer_norm(sd, p):
    return {"scale": _np(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}


def conv1d(sd, p, bias=True):
    """torch Conv1d (O, I, K) -> flax (K, I, O)."""
    out = {"kernel": _np(sd[f"{p}.weight"]).transpose(2, 1, 0)}
    if bias:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


def conv_tbc(sd, p):
    """reference ConvTBC weight is already (K, C_in, C_out) (model.py:71-72)."""
    return {"kernel": _np(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}


def ln_conv(sd, p):
    """reference ConvLayer = LayerNorm + ConvTBC (model.py:78-96)."""
    return {"LayerNorm_0": layer_norm(sd, f"{p}.layer_norm"),
            "Conv_0": conv_tbc(sd, f"{p}.conv")}


def mha_self(sd, p):
    """fairseq-style packed self-attention, no biases
    (operations.py:304-354 with bias=False)."""
    w = _np(sd[f"{p}.in_proj_weight"])  # (3C, C)
    c = w.shape[1]
    kernel = w.reshape(3, c, c).transpose(2, 0, 1)  # (C_in, 3, C_out)
    return {
        "in_proj": {"kernel": kernel},
        "out_proj": {"kernel": _np(sd[f"{p}.out_proj.weight"]).T},
    }


def mha_cross(sd, p):
    """Packed qkv split into separate projections for CrossAttention."""
    w = _np(sd[f"{p}.in_proj_weight"])
    c = w.shape[1]
    wq, wk, wv = w[:c], w[c : 2 * c], w[2 * c :]
    return {
        "q_proj": {"kernel": wq.T},
        "k_proj": {"kernel": wk.T},
        "v_proj": {"kernel": wv.T},
        "out_proj": {"kernel": _np(sd[f"{p}.out_proj.weight"]).T},
    }


def conv_ffn(sd, p, kernel_size=9):
    """reference TransformerFFNLayer (operations.py:644-692): k shifted
    Linears (bias on tap 0 only) == one SAME conv."""
    if f"{p}.ffn_1.weight" in sd:  # kernel_size == 1 variant: a plain Linear
        return {"ffn_1": linear(sd, f"{p}.ffn_1"),
                "ffn_2": linear(sd, f"{p}.ffn_2")}
    taps = [_np(sd[f"{p}.ffn_1.{i}.weight"]).T for i in range(kernel_size)]
    # reference quirk (operations.py:684: `shifted = padded[i:...] if i else x`):
    # tap 0 is applied to the *unshifted* input, i.e. it lands on the center
    # tap, and position -((k-1)//2) is effectively zero. Fold that into the
    # equivalent conv kernel so converted weights reproduce it exactly.
    kernel = np.stack([np.zeros_like(taps[0])] + taps[1:], axis=0)
    kernel[(kernel_size - 1) // 2] += taps[0]
    return {
        "ffn_1": {"kernel": kernel, "bias": _np(sd[f"{p}.ffn_1.0.bias"])},
        "ffn_2": linear(sd, f"{p}.ffn_2"),
    }


def new_conv_ffn(sd, p):
    """reference NewTransformerFFNLayer (operations.py:725-781): a true
    Conv1d -> Linear. With padding='LEFT' the conv sits inside an
    nn.Sequential behind a ConstantPad1d, so its params live at
    `ffn_1.1.*`; SAME keeps them at `ffn_1.*`. No tap-0 quirk here."""
    c1 = f"{p}.ffn_1" if f"{p}.ffn_1.weight" in sd else f"{p}.ffn_1.1"
    return {"ffn_1": conv1d(sd, c1), "ffn_2": linear(sd, f"{p}.ffn_2")}


def enc_sa_layer(sd, p, kernel_size=9):
    """reference EncSALayer via TransformerEncoderLayer wrapper: params live
    under `<p>.op.` (model.py:50-59)."""
    return {
        "layer_norm1": layer_norm(sd, f"{p}.op.layer_norm1"),
        "self_attn": mha_self(sd, f"{p}.op.self_attn"),
        "layer_norm2": layer_norm(sd, f"{p}.op.layer_norm2"),
        "ffn": conv_ffn(sd, f"{p}.op.ffn", kernel_size),
    }


def encoder_stack(sd, p, n_layers=6, last_ln=True, ffn_kernel=9):
    out = {"pre": ln_conv(sd, _j(p, "pre")),
           "out_proj": ln_conv(sd, _j(p, "out_proj"))}
    for i in range(n_layers):
        out[f"layers_{i}"] = enc_sa_layer(sd, _j(p, f"layers.{i}"), ffn_kernel)
    if last_ln:
        out["layer_norm"] = layer_norm(sd, _j(p, "layer_norm"))
    return out


def phone_encoder(sd, p="", n_layers=6):
    w = _np(sd[_j(p, "spk_proj.weight")])  # Conv1d (C_out, 100, 1)
    return {
        "spk_proj": {"kernel": w[:, :, 0].T, "bias": _np(sd[_j(p, "spk_proj.bias")])},
        "stack": encoder_stack(sd, p, n_layers=n_layers),
    }


def prompt_encoder(sd, p="", n_layers=6):
    return {"stack": encoder_stack(sd, p, n_layers=n_layers)}


def attention_pooling(sd, p):
    """reference unet1d/embeddings.py:499-546."""
    return {
        "positional_embedding": _np(sd[f"{p}.positional_embedding"]),
        "q_proj": linear(sd, f"{p}.q_proj"),
        "k_proj": linear(sd, f"{p}.k_proj"),
        "v_proj": linear(sd, f"{p}.v_proj"),
    }


def text_time_embedding(sd, p):
    """reference unet1d/embeddings.py:421-434."""
    return {
        "norm1": layer_norm(sd, f"{p}.norm1"),
        "pool": attention_pooling(sd, f"{p}.pool"),
        "proj": linear(sd, f"{p}.proj"),
        "norm2": layer_norm(sd, f"{p}.norm2"),
    }


# ---------------------------------------------------------------------------
# UNet1DConditionModel (reference unet1d/unet_1d_condition.py:61-1037)
# ---------------------------------------------------------------------------

def group_norm(sd, p):
    return {"scale": _np(sd[f"{p}.weight"]), "bias": _np(sd[f"{p}.bias"])}


def conv1x1_as_dense(sd, p, bias=True):
    """torch Conv1d k=1 (O, I, 1) -> flax Dense (I, O)."""
    out = {"kernel": _np(sd[f"{p}.weight"])[:, :, 0].T}
    if bias:
        out["bias"] = _np(sd[f"{p}.bias"])
    return out


def diffusers_attention(sd, p):
    """reference unet1d/attention_processor.py Attention: to_q/k/v no bias,
    to_out.0 with bias."""
    return {
        "to_q": linear(sd, f"{p}.to_q", bias=False),
        "to_k": linear(sd, f"{p}.to_k", bias=False),
        "to_v": linear(sd, f"{p}.to_v", bias=False),
        "to_out_0": linear(sd, f"{p}.to_out.0"),
    }


def basic_transformer_block(sd, p):
    """reference unet1d/attention.py:26-203 (GEGLU ff at net.0/net.2)."""
    return {
        "norm1": layer_norm(sd, f"{p}.norm1"),
        "attn1": diffusers_attention(sd, f"{p}.attn1"),
        "norm2": layer_norm(sd, f"{p}.norm2"),
        "attn2": diffusers_attention(sd, f"{p}.attn2"),
        "norm3": layer_norm(sd, f"{p}.norm3"),
        "ff": {"proj": linear(sd, f"{p}.ff.net.0.proj"),
               "out": linear(sd, f"{p}.ff.net.2")},
    }


def transformer_1d(sd, p):
    """reference unet1d/transformer_1d.py:41-326."""
    return {
        "norm": group_norm(sd, f"{p}.norm"),
        "proj_in": conv1x1_as_dense(sd, f"{p}.proj_in"),
        "blocks_0": basic_transformer_block(sd, f"{p}.transformer_blocks.0"),
        "proj_out": conv1x1_as_dense(sd, f"{p}.proj_out"),
    }


def dual_transformer_1d(sd, p):
    """reference unet1d/dual_transformer_1d.py:21-155 (two Transformer2DModel
    children under .transformers.{0,1})."""
    pre = f"{p}.transformers" if p else "transformers"
    return {
        "transformers_0": transformer_1d(sd, f"{pre}.0"),
        "transformers_1": transformer_1d(sd, f"{pre}.1"),
    }


def resnet_block(sd, p):
    """reference unet1d/resnet.py:461-640 (scale_shift)."""
    out = {
        "norm1": group_norm(sd, f"{p}.norm1"),
        "conv1": conv1d(sd, f"{p}.conv1"),
        "time_emb_proj": linear(sd, f"{p}.time_emb_proj"),
        "norm2": group_norm(sd, f"{p}.norm2"),
        "conv2": conv1d(sd, f"{p}.conv2"),
    }
    if f"{p}.conv_shortcut.weight" in sd:
        out["conv_shortcut"] = conv1d(sd, f"{p}.conv_shortcut")
    return out


def unet_condition(sd, p="", n_levels=4, layers_per_block=2):
    """Full UNet1DConditionModel state dict -> flax params for
    ns2vc_tpu.models.unet.UNet1DConditionModel."""
    out = {
        "conv_in": conv1d(sd, _j(p, "conv_in")),
        "time_embedding": {
            "linear_1": linear(sd, _j(p, "time_embedding.linear_1")),
            "linear_2": linear(sd, _j(p, "time_embedding.linear_2")),
        },
        "add_embedding": text_time_embedding(sd, _j(p, "add_embedding")),
        "conv_norm_out": group_norm(sd, _j(p, "conv_norm_out")),
        "conv_out": conv1d(sd, _j(p, "conv_out")),
    }
    for i in range(n_levels):
        is_last = i == n_levels - 1
        for j in range(layers_per_block):
            out[f"down_{i}_resnet_{j}"] = resnet_block(
                sd, _j(p, f"down_blocks.{i}.resnets.{j}"))
            if not is_last:
                out[f"down_{i}_attn_{j}"] = transformer_1d(
                    sd, _j(p, f"down_blocks.{i}.attentions.{j}"))
        if not is_last:
            out[f"down_{i}_downsample"] = {
                "conv": conv1d(sd, _j(p, f"down_blocks.{i}.downsamplers.0.conv"))}
    out["mid_resnet_0"] = resnet_block(sd, _j(p, "mid_block.resnets.0"))
    out["mid_attn_0"] = transformer_1d(sd, _j(p, "mid_block.attentions.0"))
    out["mid_resnet_1"] = resnet_block(sd, _j(p, "mid_block.resnets.1"))
    for i in range(n_levels):
        is_first = i == 0
        is_last = i == n_levels - 1
        for j in range(layers_per_block + 1):
            out[f"up_{i}_resnet_{j}"] = resnet_block(
                sd, _j(p, f"up_blocks.{i}.resnets.{j}"))
            if not is_first:
                out[f"up_{i}_attn_{j}"] = transformer_1d(
                    sd, _j(p, f"up_blocks.{i}.attentions.{j}"))
        if not is_last:
            out[f"up_{i}_upsample"] = {
                "conv": conv1d(sd, _j(p, f"up_blocks.{i}.upsamplers.0.conv"))}
    return out


# ---------------------------------------------------------------------------
# Full NaturalSpeech2 checkpoint (reference model.py:439-745; saved as
# {'step', 'model'} by Trainer.save, model.py:808-817)
# ---------------------------------------------------------------------------

# Non-parameter buffers the reference registers on NaturalSpeech2
# (model.py:471-498) — the flax model recomputes all of them from config
# (diffusion/schedule.py), so they are legitimately unconsumed.
_NS2_BUFFER_IGNORE = (
    r"betas", r"alphas_cumprod(_prev)?",
    r"sqrt_alphas_cumprod", r"sqrt_one_minus_alphas_cumprod",
    r"log_one_minus_alphas_cumprod", r"sqrt_recip(m1)?_alphas_cumprod",
    r"posterior_variance", r"posterior_log_variance_clipped",
    r"posterior_mean_coef[12]", r"loss_weight",
)


def natural_speech2(sd, n_encoder_layers=6, strict=True):
    """Full reference model state dict -> flax params for
    ns2vc_tpu.models.diffusion.NaturalSpeech2. With `strict` (default),
    any source key neither converted nor a known schedule buffer raises
    (guards against upstream key-layout drift)."""
    sd = TrackedStateDict(
        {k.removeprefix("module."): v for k, v in sd.items()})  # DDP prefix
    params = {
        "pre_model": {
            "ref_enc": text_time_embedding(sd, "pre_model.ref_enc"),
            "prompt_encoder": prompt_encoder(
                sd, "pre_model.prompt_encoder", n_layers=n_encoder_layers),
            "phoneme_encoder": phone_encoder(
                sd, "pre_model.phoneme_encoder", n_layers=n_encoder_layers),
        },
        "diff_model": {"unet": unet_condition(sd, "diff_model.unet")},
    }
    if strict:
        assert_fully_consumed(sd, ignore=_NS2_BUFFER_IGNORE,
                              context="natural_speech2")
    return params


def load_reference_checkpoint(path: str):
    """torch.load a reference `model-{N}.pt` -> (flax params, step)."""
    import torch

    data = torch.load(path, map_location="cpu")
    return natural_speech2(data["model"]), int(data.get("step", 0))
