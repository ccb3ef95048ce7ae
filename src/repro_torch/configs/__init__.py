"""Architecture configs and step builders of the port: the LM family of
the JAX package's registry (``registry``), one module per arch, and the
prefill / decode cells (``steps``)."""
