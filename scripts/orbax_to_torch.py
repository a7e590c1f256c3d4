"""Convert a JAX trainer's orbax checkpoint into a checkpoint of the
PyTorch port's trainer.

Usage: python scripts/orbax_to_torch.py --run RUN_DIR --out model-N.pt \
           [--step N] [-c config.json]

Reads RUN_DIR/ckpt/<step> (the newest step unless --step) as the JAX
package's `Trainer.load` reads it: the TrainState restored against its
abstract shape, which the run's config (RUN_DIR/config.json unless -c)
gives through the JAX package. Writes, through the port's
`convert.from_flax`, the layout the port's `Trainer.save` writes: the step,
the parameters, the EMA parameters when the run kept them, AdamW's state
from optax's (count, mu, nu), and the config. The port's `Svc` (EMA
preferred) and `Trainer.load` read it; a resumed port run takes the next
step as the JAX run would have.

It imports JAX and the JAX package, so it is not one of the port's
torch-only scripts (scripts/torch_*.py).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def restore(run_dir: str, config_path: str, step=None):
    """The JAX TrainState at `step` (newest if None) of a run, as numpy,
    and its step."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import orbax.checkpoint as ocp

    from ns2vc_tpu.config import load_config
    from ns2vc_tpu.models.diffusion import NaturalSpeech2
    from ns2vc_tpu.train.trainer import TrainState, dummy_batch, make_optimizer

    cfg = load_config(config_path)
    model, optimizer = NaturalSpeech2(cfg), make_optimizer(cfg)
    batch = dummy_batch(cfg)

    def init(rng):
        params = model.init(rng, batch, rng)
        return TrainState(step=jnp.zeros((), jnp.int32), params=params,
                          opt_state=optimizer.init(params),
                          ema_params=params if cfg.train.use_ema else None)

    abstract = jax.eval_shape(init, jax.random.PRNGKey(0))
    mgr = ocp.CheckpointManager(os.path.abspath(os.path.join(run_dir,
                                                             "ckpt")))
    step = step if step is not None else mgr.latest_step()
    if step is None:
        raise SystemExit(f"orbax_to_torch: no checkpoint in {run_dir}/ckpt")
    # a numpy target, as Trainer.load restores in one process
    target = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), abstract)
    state = mgr.restore(step, args=ocp.args.StandardRestore(target))
    return jax.tree.map(np.asarray, state), int(step)


def _adam(opt_state):
    """optax's ScaleByAdamState (count, mu, nu) inside the chained state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam(s)
            if found is not None:
                return found
    return None


def convert(run_dir: str, out: str, step=None, config_path=None) -> str:
    import torch

    from ns2vc_tpu_torch.config import load_config
    from ns2vc_tpu_torch.convert import from_flax, save_trainer_checkpoint
    from ns2vc_tpu_torch.models.diffusion import NaturalSpeech2
    from ns2vc_tpu_torch.train.trainer import make_optimizer

    config_path = config_path or os.path.join(run_dir, "config.json")
    state, step = restore(run_dir, config_path, step)
    cfg = load_config(config_path)
    params = from_flax(state.params, cfg)
    ema = (from_flax(state.ema_params, cfg)
           if state.ema_params is not None else None)
    adam = _adam(state.opt_state)
    opt_state = None
    if adam is not None:
        model = NaturalSpeech2(cfg)
        opt = make_optimizer(cfg, model.parameters())
        mu, nu = from_flax(adam.mu, cfg), from_flax(adam.nu, cfg)
        for name, p in model.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(adam.count)),
                            "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        opt_state = opt.state_dict()
    save_trainer_checkpoint(out, cfg, params, int(state.step), opt_state,
                            ema)
    n = sum(v.numel() for v in params.values())
    print(f"converted {run_dir} step {step} ({n / 1e6:.1f} M parameters"
          f"{', EMA' if ema is not None else ''}"
          f"{', AdamW state' if opt_state is not None else ''}) -> {out}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run", required=True,
                   help="the JAX trainer's run dir (holds ckpt/)")
    p.add_argument("--out", required=True, help="the port checkpoint (.pt)")
    p.add_argument("--step", type=int, default=None)
    p.add_argument("-c", "--config", default=None,
                   help="the run's config.json (default RUN/config.json)")
    args = p.parse_args(argv)
    return convert(args.run, args.out, args.step, args.config)


if __name__ == "__main__":
    main()
