"""Reference input signals (``signals``) and the LM token pipelines
(``pipeline``)."""
from . import signals
from .signals import ALPHAS_FREQ, mso_series

__all__ = ["signals", "ALPHAS_FREQ", "mso_series"]
