"""Reference input signals."""
