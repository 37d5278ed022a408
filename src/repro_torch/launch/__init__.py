"""Entry points: the DRACO LM trainer and its step functions."""
