"""Training of the port: optimizers, gradient compression, checkpoints and
the trainer (the JAX package's ``train/``; its multi-device
``pipeline.py`` is ROADMAP A11)."""
from . import optimizer

__all__ = ["optimizer"]
