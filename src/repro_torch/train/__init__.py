"""Training substrate of the port: optimizers, gradient compression,
checkpoints and the train loop (repro's ``train/`` without JAX)."""
