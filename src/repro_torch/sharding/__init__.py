"""Sharding plans (``sharding.rules``): the LM's on a device mesh, and the
serving slot arena's."""
from . import rules

__all__ = ["rules"]
