"""Convert a reference model-{N}.pt checkpoint into a checkpoint of the
PyTorch port's trainer offline (the port's counterpart of
scripts/convert_checkpoint.py; `train.cli --warm_start` and `Svc` also
read the reference file directly).

Usage: python scripts/torch_convert_checkpoint.py --pt model-679.pt \
           --out model-679-port.pt [-c config.json]

The output holds the step and the converted parameters (no optimizer
state: a resumed run starts AdamW fresh, and the EMA from the
parameters), in the layout `Trainer.load` and `Svc` read.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pt", required=True, help="reference model-{N}.pt")
    p.add_argument("--out", required=True, help="the port checkpoint (.pt)")
    p.add_argument("-c", "--config", default=None)
    args = p.parse_args(argv)

    import torch

    from ns2vc_tpu_torch.config import load_config
    from ns2vc_tpu_torch.convert import (
        load_checkpoint, save_trainer_checkpoint,
    )

    cfg = load_config(args.config)
    data = torch.load(args.pt, map_location="cpu")
    if "model" not in data:
        raise SystemExit(f"{args.pt} is not a reference model-N.pt "
                         f"({{'step', 'model'}})")
    params = load_checkpoint(args.pt, cfg)
    step = int(data.get("step", 0))
    save_trainer_checkpoint(args.out, cfg, params, step)
    n = sum(v.numel() for v in params.values())
    print(f"converted {args.pt} (step {step}, {n / 1e6:.1f} M parameters) "
          f"-> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
