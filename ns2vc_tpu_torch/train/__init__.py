"""Training on one card: the train step, the Trainer and its CLI."""

from ns2vc_tpu_torch.train.trainer import TrainState, Trainer, make_train_step

__all__ = ["Trainer", "TrainState", "make_train_step"]
