"""The port's encoder op registry (`models/op_registry.py`) and
`DualTransformer1D` against the JAX package's, on the CPU.

Every id of OPERATIONS_ENCODER (13 with and without its Gaussian bias) at
C = 32, T = 40, B = 2 with a padded item, flax-initialised weights filled
from a seed and converted by `convert.from_flax_tree` (the BiLSTM's two
flax cells mapped onto `torch.nn.LSTM`): 2e-5, the JAX suite's encoder
bound. DualTransformer1D with a padded prompt: 5e-4, its UNet bound. The
routing of each layer's attention (`ops/attention.py`): the banded layer
and the Gaussian bias take the plain route, the others the kernel's (at
C = 32 the Gaussian layer's one head is D = 32; at C = 256 its D = 256
would take the plain route too).
"""

import numpy as np
import pytest
import torch

import jax

from ns2vc_tpu.models import op_registry as jreg
from ns2vc_tpu.models import unet as junet
from ns2vc_tpu_torch.convert import from_flax_tree, init_module_
from ns2vc_tpu_torch.models import op_registry as treg
from ns2vc_tpu_torch.models import unet as tunet
from ns2vc_tpu_torch.ops.flash_attention import flash_attention
from test_torch_slice import _filled_tree

ENC_ATOL, UNET_ATOL = 2e-5, 5e-4
C, T, B = 32, 40, 2
CASES = [(i, {}) for i in range(1, 16)] + [(13, {"g_bias": True,
                                                 "tao": 3.0})]


def _inputs():
    r = np.random.default_rng(0)
    x = r.standard_normal((B, T, C)).astype(np.float32)
    mask = np.arange(T)[None] < np.array([T, 27])[:, None]
    return r, x, mask


def _layers(op_id, kw):
    jm = jreg.OPERATIONS_ENCODER[op_id](C, 0.1, **kw)
    tm = treg.OPERATIONS_ENCODER[op_id](C, 0.1, **kw)
    r, x, mask = _inputs()
    params = _filled_tree(lambda k, *a: jm.init(k, *a), r, x, mask)
    tm.load_state_dict(from_flax_tree(jax.tree.map(np.asarray, params), tm))
    return jm, params, tm.eval(), x, mask


@pytest.mark.parametrize("op_id,kw", CASES, ids=[
    f"{i}{'-gaus' if kw else ''}" for i, kw in CASES])
def test_op_matches_jax(op_id, kw):
    jm, params, tm, x, mask = _layers(op_id, kw)
    want = np.asarray(jm.apply(params, x, mask))
    plain0 = flash_attention.route_launches["plain"]
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.shape == (B, T, C)
    np.testing.assert_allclose(got.numpy(), want, atol=ENC_ATOL)
    routed = flash_attention.route_launches["plain"] - plain0
    assert routed == (1 if op_id == 11 or kw.get("g_bias") else 0)


def test_local_attention_is_banded_and_zeroes_padded_rows():
    _, _, tm, x, mask = _layers(11, {})
    layer = treg.EncLocalSALayer(C, 2, chunk_size=9)
    layer.load_state_dict(tm.state_dict())
    layer.eval()
    x = torch.from_numpy(x)
    m = torch.from_numpy(mask)
    far = x.clone()
    far[0, 30] += 10.0        # outside query 0's band [0, 9)
    with torch.no_grad():
        a, b = layer(x, m), layer(far, m)
        attn = layer.out_proj(torch.zeros(B, T, C))  # no bias: zero rows
    assert torch.allclose(a[0, 0], b[0, 0], atol=1e-6)
    assert not torch.allclose(a[0, 30], b[0, 30])
    assert not attn.any()
    band = layer.band_bias(12, "cpu")[0, 0]
    assert (band[0, :9] == 0).all() and (band[0, 9:] < 0).all()


def test_lstm_weights_map_onto_torch_lstm():
    jm, params, tm, x, mask = _layers(12, {})
    cell = jax.tree.map(np.asarray, params)["params"]["OptimizedLSTMCell_1"]
    w = tm.lstm.weight_hh_l0_reverse.detach().numpy()
    np.testing.assert_allclose(w[2 * C:3 * C], cell["hg"]["kernel"].T,
                               rtol=1e-6)
    assert not tm.lstm.bias_ih_l0.any()


def test_init_covers_every_op():
    for op_id, kw in CASES:
        layer = init_module_(treg.OPERATIONS_ENCODER[op_id](C, 0.0, **kw),
                             torch.Generator().manual_seed(op_id)).eval()
        _, x, mask = _inputs()
        with torch.no_grad():
            y = layer(torch.from_numpy(x), torch.from_numpy(mask))
        assert torch.isfinite(y).all() and not torch.equal(
            y, torch.from_numpy(x)), op_id


def test_dual_transformer_matches_jax():
    r = np.random.default_rng(4)
    x = r.standard_normal((B, 16, 24)).astype(np.float32)
    ctx = r.standard_normal((B, 11, 20)).astype(np.float32)
    keep = np.arange(11)[None] < np.array([11, 8])[:, None]
    bias = np.where(keep, 0.0, -1e4).astype(np.float32)[:, None, None, :]
    kw = dict(condition_lengths=(4, 7), transformer_index_for_condition=(1, 0),
              mix_ratio=0.3)
    jm = junet.DualTransformer1D(24, 4, 20, **kw)
    params = _filled_tree(lambda k, *a: jm.init(k, *a), r, x, ctx, bias)
    want = np.asarray(jax.jit(jm.apply)(params, x, ctx, bias))
    tm = tunet.DualTransformer1D(24, 4, 20, **kw)
    tm.load_state_dict(from_flax_tree(jax.tree.map(np.asarray, params), tm))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), torch.from_numpy(ctx),
                        torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), want, atol=UNET_ATOL)
