"""Training of the port: optimizers, gradient compression, checkpoints, the
trainer and the pipeline-parallel stage loop (the JAX package's
``train/``)."""
from . import optimizer

__all__ = ["optimizer"]
