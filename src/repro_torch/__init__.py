"""repro_torch: Star Pattern Fragments (SPF) on PyTorch and CUDA.

A module-by-module port of the JAX package ``repro``: the same public
names and signatures, with torch tensors in place of jnp arrays.  Every
probe of the serial query path runs through a CUDA kernel written by hand
for Hopper (``repro_torch.kernels``); a tensor on the CPU takes the
kernel's plain PyTorch version instead.

Entry points run on the card unless the caller asks for the CPU:
``QueryEngine(..., device=None)`` and ``TripleStore.device_arrays()``
default to ``"cuda"`` and raise where there is none.  Keys are int64,
rows and positions int32, stats int64, everywhere and explicitly.
"""

__version__ = "0.1.0"
