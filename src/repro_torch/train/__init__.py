"""Training of the port: optimizers, gradient compression, checkpoints and
the trainer (the JAX package's ``train/``, without the multi-device
pipeline, ROADMAP A11)."""
