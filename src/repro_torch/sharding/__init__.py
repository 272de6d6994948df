"""Placement rules of the sharded slot arena (``sharding.rules``)."""
from . import rules

__all__ = ["rules"]
