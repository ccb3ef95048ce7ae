"""Model zoo of the port: the dense decoder-only LM (``transformer``) and
its layers (``layers``).  The other families of the JAX package (MoE,
GNNs, DeepFM) are not ported yet."""
