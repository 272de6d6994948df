"""Reference input signals (``signals``) and the LM token pipelines
(``pipeline``)."""
