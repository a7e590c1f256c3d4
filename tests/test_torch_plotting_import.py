"""The port's plotting, the Trainer's spectrogram images, and checkpoint
import, against the JAX package's, on the CPU.

- `plot_spectrogram_to_numpy`, `plot_data_to_numpy` and
  `plot_alignment_to_numpy` give the JAX package's arrays bit for bit on
  seeded inputs (one implementation, copied).
- The Trainer writes the JAX Trainer's four images as PNGs (`all/spec`,
  `all/spec_pred` at log steps, `gen/mel`, `gt/mel` at eval); without
  matplotlib it writes none and says so once, on stdout and in train.log.
- A JAX Trainer's orbax checkpoint (EMA and AdamW moments that differ from
  the parameters) -> scripts/orbax_to_torch.py -> a port checkpoint: the
  EMA model's full training forward (loss and prediction, fixed t and
  noise) matches JAX's at 1e-3; `Trainer.load` restores the parameters,
  the EMA, optax's moments as AdamW's and the step.
- scripts/torch_mix_models.py against `ns2vc_tpu.utils.checkpoints.
  mix_models` (1e-6 relative), and scripts/torch_convert_checkpoint.py
  against the JAX converter's tree, both through `Trainer.load`.
- `mha_cross`, `new_conv_ffn` (both layouts), `dual_transformer_1d` and
  `load_reference_checkpoint` against the JAX converter's on synthetic
  reference state dicts: equal trees.
"""

import importlib.util
import json
import os
import sys
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ns2vc_tpu.utils import convert_reference as jcr
from ns2vc_tpu.utils import plotting as jplot
from ns2vc_tpu_torch.convert import from_flax, load_checkpoint
from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
from ns2vc_tpu_torch.train import trainer as ttrainer
from ns2vc_tpu_torch.utils import convert_reference as pcr
from ns2vc_tpu_torch.utils import plotting as tplot
from test_torch_data import write_features
from test_torch_host import _equal_trees, _reference_state_dict
from test_torch_slice import _filled_tree
from test_torch_train import _batch, _draws, _trainer_config, configs


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's tests: their models are small,
    and the suite's test workers share the host's cores, where several
    OpenMP teams per core stall at their barriers (on an 8-core CPU host,
    alone, 1 thread runs `test_torch_f0.py::test_trainer_serves_a_
    predictor_checkpoint` in 14.7 s against 45.3 with 8)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORWARD_ATOL = 1e-3      # the JAX suite's full-model bound
MIX_RTOL = 1e-6


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fn,args", [
    ("plot_spectrogram_to_numpy", ((100, 60),)),
    ("plot_data_to_numpy", ((80,), (80,))),
    ("plot_alignment_to_numpy", ((30, 20),)),
])
def test_plots_match_jax(fn, args):
    r = np.random.default_rng(len(fn))
    inputs = [r.standard_normal(s).astype(np.float32) for s in args]
    got = getattr(tplot, fn)(*inputs)
    want = getattr(jplot, fn)(*inputs)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)


def test_trainer_writes_the_four_spectrogram_images(tmp_path):
    import matplotlib.image

    cfg = _trainer_config(str(tmp_path), train_num_steps=1,
                          save_and_sample_every=1, remat=False)
    logs = str(tmp_path / "run")
    tr = ttrainer.Trainer(cfg, logs_folder=logs, device="cpu")
    tr.train()
    images = sorted(os.listdir(os.path.join(logs, "images")))
    assert images == ["all_spec-1.png", "all_spec_pred-1.png",
                      "gen_mel-1.png", "gt_mel-1.png"]
    for name in images:
        im = matplotlib.image.imread(os.path.join(logs, "images", name))
        assert im.ndim == 3 and im.shape[0] > 50 and im.shape[1] > 200
    with open(os.path.join(logs, "scalars.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if "gen_mel" in r]
    assert evals[0]["gen/mel"].endswith("gen_mel-1.png")


def test_trainer_without_matplotlib_says_so_once(tmp_path, monkeypatch,
                                                 capsys):
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None
                        if name == "matplotlib" else real(name, *a))
    cfg = _trainer_config(str(tmp_path), train_num_steps=2,
                          save_and_sample_every=100, remat=False)
    logs = str(tmp_path / "no_plots")   # get_logger keys on the basename
    ttrainer.Trainer(cfg, logs_folder=logs, device="cpu").train()
    out = capsys.readouterr().out
    assert out.count("matplotlib is not installed") == 1
    assert not os.path.exists(os.path.join(logs, "images"))
    with open(os.path.join(logs, "train.log")) as f:
        assert f.read().count("matplotlib is not installed") == 1


# -- checkpoint import --------------------------------------------------------

def _moments(tree, r):
    """Values of the flax tree's shape, seeded."""
    return jax.tree.map(
        lambda a: r.standard_normal(a.shape).astype(np.float32) * 1e-2, tree)


def test_orbax_run_to_a_port_checkpoint(tmp_path):
    from ns2vc_tpu.config import save_config as jsave_config
    from ns2vc_tpu.models import diffusion as jdiff
    from ns2vc_tpu.train import trainer as jtrainer

    feats = write_features(str(tmp_path / "feats"), [40, 56, 64, 48])
    jcfg, cfg = configs(levels=(16, 24), p_dropout=0.0,
                        data={"training_files": feats, "val_files": feats},
                        train_batch_size=2, max_content_frames=40,
                        max_refer_frames=32, num_workers=0, use_ema=True,
                        remat=False, compute_dtype="float32")
    r = np.random.default_rng(5)
    batch = _batch(r)
    jm = jdiff.NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, batch, k), r)
    ema = _moments(params, r)
    ema = jax.tree.map(lambda p, e: p + e, params, ema)
    opt = jtrainer.make_optimizer(jcfg)
    opt_state = opt.init(params)
    update = jax.jit(opt.update)
    for _ in range(2):     # two updates: count 2, moments that differ
        _, opt_state = update(_moments(params, r), opt_state, params)
    run = str(tmp_path / "jax_run")
    os.makedirs(run)
    jsave_config(jcfg, os.path.join(run, "config.json"))
    # the JAX Trainer's own save of this state
    tr = jtrainer.Trainer.__new__(jtrainer.Trainer)
    tr.cfg, tr.logs_folder, tr.n_proc, tr._ckpt_mgr = jcfg, run, 1, None
    tr.state = jtrainer.TrainState(step=jnp.asarray(7, jnp.int32),
                                   params=params, opt_state=opt_state,
                                   ema_params=ema)
    tr.save()

    out = str(tmp_path / "model-7.pt")
    _script("orbax_to_torch").main(["--run", run, "--out", out])

    # the EMA model's training forward against JAX's
    model = NaturalSpeech2(cfg).eval()
    model.load_state_dict(load_checkpoint(out, cfg))
    key = jax.random.PRNGKey(9)
    jloss, jaux = jax.jit(lambda p: jm.apply(p, batch, key,
                                             deterministic=True))(ema)
    t, noise = _draws(key, 2, 16)
    with torch.no_grad():
        loss, aux = model({k: torch.from_numpy(v) for k, v in batch.items()},
                          t=torch.from_numpy(np.array(t)),
                          noise=torch.from_numpy(np.array(noise)))
    np.testing.assert_allclose(aux["pred"].numpy(), np.asarray(jaux["pred"]),
                               atol=FORWARD_ATOL)
    assert loss.item() == pytest.approx(float(jloss), rel=FORWARD_ATOL)

    # resume: parameters, EMA, optax's moments as AdamW's, the step
    port = ttrainer.Trainer(cfg, logs_folder=str(tmp_path / "port"),
                            device="cpu")
    port.load(path=out)
    assert port.step == 7
    want = from_flax(params, cfg)
    for k, v in port.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    want_ema = from_flax(ema, cfg)
    for k, v in port.state.ema_params.items():
        assert torch.equal(v, want_ema[k]), k
    adam = _script("orbax_to_torch")._adam(opt_state)
    mu, nu = from_flax(adam.mu, cfg), from_flax(adam.nu, cfg)
    for name, p in port.model.named_parameters():
        st = port.state.optimizer.state[p]
        assert float(st["step"]) == 2.0, name
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
    port.close()


def test_torch_mix_models_matches_jax_mix(tmp_path):
    from ns2vc_tpu.utils import checkpoints as jck

    jcfg, cfg = configs(levels=(16, 24))
    r = np.random.default_rng(3)
    batch = _batch(r)
    jm = __import__("ns2vc_tpu.models.diffusion",
                    fromlist=["NaturalSpeech2"]).NaturalSpeech2(jcfg)
    first = _filled_tree(lambda k: jm.init(k, batch, k), r)
    trees = [first] + [jax.tree.map(lambda a: a + 0.1 * r.standard_normal(
        a.shape).astype(np.float32), first) for _ in range(2)]
    ratios = [0.5, 0.3, 0.2]
    paths = []
    for i, tree in enumerate(trees):
        paths.append(str(tmp_path / f"in{i}.pt"))
        torch.save(from_flax(tree, cfg), paths[-1])
    config = str(tmp_path / "config.json")
    from ns2vc_tpu_torch.config import save_config

    save_config(cfg, config)
    out = str(tmp_path / "mixed.pt")
    _script("torch_mix_models").main(
        ["--pts", *paths, "--ratios", *map(str, ratios), "--out", out,
         "-c", config])
    want = from_flax(jax.tree.map(np.asarray, jck.mix_models(trees, ratios)),
                     cfg)
    got = load_checkpoint(out, cfg)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=MIX_RTOL,
                                   atol=1e-7, err_msg=k)
    tr = ttrainer.Trainer(_trainer_config(str(tmp_path)),
                          logs_folder=str(tmp_path / "run"), device="cpu")
    tr.load(path=out)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_torch_convert_checkpoint_matches_the_jax_converter(tmp_path,
                                                            monkeypatch):
    jcfg, cfg = configs(levels=(16, 24))
    r = np.random.default_rng(7)
    jm = __import__("ns2vc_tpu.models.diffusion",
                    fromlist=["NaturalSpeech2"]).NaturalSpeech2(jcfg)
    params = _filled_tree(lambda k: jm.init(k, _batch(r), k), r)
    # the tiny model stands in for the reference key mapping (the key
    # mapping itself: tests/test_torch_host.py)
    monkeypatch.setattr(pcr, "natural_speech2",
                        lambda sd: jax.tree.map(np.asarray, params)["params"])
    torch.save({"step": 17, "model": {"x": torch.zeros(1)}},
               tmp_path / "model-17.pt")
    from ns2vc_tpu_torch.config import save_config

    save_config(cfg, str(tmp_path / "config.json"))
    out = str(tmp_path / "port.pt")
    _script("torch_convert_checkpoint").main(
        ["--pt", str(tmp_path / "model-17.pt"), "--out", out,
         "-c", str(tmp_path / "config.json")])
    tr = ttrainer.Trainer(_trainer_config(str(tmp_path)),
                          logs_folder=str(tmp_path / "run"), device="cpu")
    tr.load(path=out)
    assert tr.step == 17
    want = from_flax(jax.tree.map(np.asarray, params), cfg)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want[k]), k
        assert torch.equal(tr.state.ema_params[k], want[k]), k


# -- the converter helpers ----------------------------------------------------

class _Synthetic(dict):
    """A reference state dict that makes each key at first access: seeded
    values (from the key) in a shape its layout takes."""

    def __missing__(self, key):
        parts = key.split(".")
        if key.endswith("in_proj_weight"):
            shape = (24, 8)
        elif parts[-1] == "bias" or "norm" in parts[-2]:
            shape = (8,)
        elif parts[-2] in ("proj_in", "proj_out"):
            shape = (8, 8, 1)
        elif "ffn_1" in parts:
            shape = (16, 8, 3)
        else:
            shape = (8, 8)
        r = np.random.default_rng(zlib.crc32(key.encode()))
        self[key] = torch.from_numpy(r.standard_normal(shape).astype(
            np.float32))
        return self[key]


@pytest.mark.parametrize("helper,prefix", [
    ("mha_cross", "enc.layers.0.attn"),
    ("new_conv_ffn", "enc.layers.0.ffn"),
    ("new_conv_ffn", "enc.layers.1.ffn"),
    ("dual_transformer_1d", "unet.mid_block.attentions.0"),
    ("dual_transformer_1d", ""),
])
def test_converter_helper_matches_jax(helper, prefix):
    sd = _Synthetic()
    if prefix == "enc.layers.0.ffn":   # padding SAME: the conv at ffn_1
        _ = sd[f"{prefix}.ffn_1.weight"]
    want = getattr(jcr, helper)(sd, prefix)
    n = len(sd)
    got = getattr(pcr, helper)(sd, prefix)
    assert len(sd) == n         # the port read the keys JAX read
    _equal_trees(got, want)


def test_load_reference_checkpoint_matches_jax(tmp_path):
    sd = _reference_state_dict(n_layers=6, seed=4)
    path = str(tmp_path / "model-21.pt")
    torch.save({"step": 21, "model": sd}, path)
    got, step = pcr.load_reference_checkpoint(path)
    want, jstep = jcr.load_reference_checkpoint(path)
    assert step == jstep == 21
    _equal_trees(got, want)
    assert sys.modules["ns2vc_tpu_torch.utils.convert_reference"] is pcr
