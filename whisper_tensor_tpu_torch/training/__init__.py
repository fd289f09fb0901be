"""Training on the port: LMTrainer (autograd over the executor, optax's
optimizers in torch) and its checkpoints."""
