"""LM model stack of the port: attention, the blocks and the LM assembly
(the JAX package's ``models``)."""
from . import attention, blocks, lm

__all__ = ["attention", "blocks", "lm"]
