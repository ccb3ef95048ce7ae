"""Synthetic inputs of the port's model cells (``synth``)."""
