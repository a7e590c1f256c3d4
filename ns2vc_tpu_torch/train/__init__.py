"""Training on one card: the train step, the Trainer and its CLI."""
