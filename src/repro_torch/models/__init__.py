"""LM model stack of the port: blocks and the LM assembly (reservoir
layers; attention is ROADMAP A12)."""
from . import blocks, lm

__all__ = ["blocks", "lm"]
