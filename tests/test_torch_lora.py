"""The port's LoRA (`models/lora.py`) against the JAX package's, on the
CPU: the same targets and factor shapes, the JAX tree converted by
`lora_from_flax`, and merged weights within 1e-6 of JAX's merge converted
by `convert.from_flax` (the self-attention parts land in the fused to_qkv
rows).
"""

import numpy as np
import pytest
import torch

import jax

from ns2vc_tpu.models import diffusion as jdiff
from ns2vc_tpu.models import lora as jlora
from ns2vc_tpu_torch.convert import from_flax
from ns2vc_tpu_torch.models import lora as tlora
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
from test_torch_slice import _filled_tree
from test_torch_train import _batch, configs

MERGE_ATOL = 1e-6


@pytest.fixture(scope="module")
def lora_pair():
    jcfg, cfg = configs()
    r = np.random.default_rng(0)
    jm = jdiff.NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, _batch(r), k), r)
    jl = jlora.init_lora(jax.random.PRNGKey(1), params, rank=3)
    # a trained adapter: nonzero up factors
    jl = {k: {"down": v["down"], "up": np.asarray(
        r.standard_normal(v["up"].shape), np.float32)} for k, v in jl.items()}
    sd = from_flax(jax.tree.map(np.asarray, params), cfg)
    return cfg, params, jl, sd


def test_targets_and_factors_are_the_jax_ones(lora_pair):
    cfg, params, jl, sd = lora_pair
    mine = tlora.init_lora(sd, torch.Generator().manual_seed(0), rank=3)
    conv = tlora.lora_from_flax(jl)
    assert set(mine) == set(conv)
    assert any(k.endswith("attn1.to_q.weight") for k in mine)
    assert not any("to_qkv" in k for k in mine)
    for k, ab in mine.items():
        assert ab["down"].shape == conv[k]["down"].shape, k
        assert ab["up"].shape == conv[k]["up"].shape, k
        assert not ab["up"].any()
    assert tlora.count_lora_params(mine) == jlora.count_lora_params(jl)
    # down ~ N(0, 1/rank)
    down = torch.cat([ab["down"].flatten() for ab in mine.values()])
    assert abs(down.std().item() - 3 ** -0.5) < 0.05
    # zero up: merging changes nothing
    merged = tlora.apply_lora(sd, mine)
    assert all(torch.equal(merged[k], sd[k]) for k in sd)


def test_merged_weights_match_jax(lora_pair):
    cfg, params, jl, sd = lora_pair
    want = from_flax(jax.tree.map(np.asarray,
                                  jlora.apply_lora(params, jl, scale=0.7)),
                     cfg)
    got = tlora.apply_lora(sd, tlora.lora_from_flax(jl), scale=0.7)
    changed = [k for k in sd if not torch.equal(got[k], sd[k])]
    assert any(k.endswith("to_qkv.weight") for k in changed)
    assert any(k.endswith("to_out_0.weight") for k in changed)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=MERGE_ATOL, err_msg=k)
    model = NaturalSpeech2(cfg)
    model.load_state_dict(got)    # the merged tree is a state dict


def test_apply_lora_rejects_an_unknown_key(lora_pair):
    _, _, _, sd = lora_pair
    bad = {"diff_model.unet.nowhere.weight": {
        "down": torch.zeros(2, 1), "up": torch.zeros(1, 2)}}
    with pytest.raises(KeyError, match="names no weight"):
        tlora.apply_lora(sd, bad)
