"""Weight-space model mixing for the PyTorch port (the counterpart of
scripts/mix_models.py; reference mix_model, utils.py:499-510): average or
ratio-blend several checkpoints into one.

Usage: python scripts/torch_mix_models.py --pts a.pt b.pt \
           [--ratios 0.5 0.5] --out mixed.pt [-c config.json]

Each input is what `convert.load_checkpoint` reads: a reference
model-{N}.pt, a checkpoint of the port's trainer (its EMA parameters when
it has them) or a port state dict. The output is a checkpoint of the
port's trainer at the largest input step, without optimizer state.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pts", nargs="+", required=True,
                   help="checkpoints to mix")
    p.add_argument("--ratios", nargs="+", type=float, default=None)
    p.add_argument("--out", required=True, help="the mixed checkpoint (.pt)")
    p.add_argument("-c", "--config", default=None)
    args = p.parse_args(argv)

    import torch

    from ns2vc_tpu_torch.config import load_config
    from ns2vc_tpu_torch.convert import (
        load_checkpoint, save_trainer_checkpoint,
    )
    from ns2vc_tpu_torch.utils.checkpoints import mix_models

    cfg = load_config(args.config)
    state_dicts, step = [], 0
    for path in args.pts:
        state_dicts.append(load_checkpoint(path, cfg))
        data = torch.load(path, map_location="cpu")
        step = max(step, int(data.get("step", 0)))
    ratios = args.ratios or [1.0 / len(state_dicts)] * len(state_dicts)
    if len(ratios) != len(state_dicts):
        raise SystemExit(f"{len(ratios)} ratios for {len(state_dicts)} "
                         f"checkpoints")
    save_trainer_checkpoint(args.out, cfg, mix_models(state_dicts, ratios),
                            step)
    print(f"mixed {len(state_dicts)} checkpoints (ratios {ratios}) -> "
          f"{args.out}")
    return args.out


if __name__ == "__main__":
    main()
