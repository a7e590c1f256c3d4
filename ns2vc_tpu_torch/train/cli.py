"""Training entry point (counterpart of the JAX package's train.py).

    python -m ns2vc_tpu_torch.train.cli [-c config.json] [--logs_folder DIR]
        [--resume] [--warm_start model-N.pt] [-d cuda|cpu]

Runs on the card unless `-d cpu` is given, and exits non-zero when the
device asked for is not there.

Several processes train one model with data parallelism when the
environment describes their group (`parallel/mesh.py`): each runs this
command with NS2VC_COORDINATOR=host:port, NS2VC_NUM_PROCESSES=n and its
own NS2VC_PROCESS_ID, or under torchrun with NS2VC_DISTRIBUTED=1. Each
process takes its own card. With `parallel.model_parallel_size` = mp > 1
the processes form (n / mp) data groups of mp, each splitting the model
over its mp ranks (tensor parallelism); `train_batch_size` is per data
group, so the global batch is n / mp times it.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    import torch

    p = argparse.ArgumentParser(
        description="Train the port's NaturalSpeech2 VC model")
    p.add_argument("-c", "--config", type=str, default=None)
    p.add_argument("--logs_folder", type=str, default=None)
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in the run dir")
    p.add_argument("--warm_start", type=str, default=None,
                   help="reference model-{N}.pt to convert and load")
    p.add_argument("-d", "--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"ns2vc_tpu_torch.train.cli: device {args.device!r} "
                         f"requested but no CUDA device is available; pass "
                         f"-d cpu to run on the CPU")

    from ns2vc_tpu_torch.parallel.mesh import maybe_initialize_distributed
    from ns2vc_tpu_torch.train.trainer import Trainer

    grouped = maybe_initialize_distributed(args.device)
    try:
        trainer = Trainer(args.config, logs_folder=args.logs_folder,
                          device=args.device)
        try:
            if args.warm_start:
                trainer.load_torch(args.warm_start)
            elif args.resume:
                trainer.load()
            trainer.train()
        finally:
            trainer.close()
    finally:
        if grouped:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
