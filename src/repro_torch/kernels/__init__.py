"""Hand-written Hopper kernels for the SPF probe path, and their seam.

Layer map (bottom-up):

- csrc/*.cu      — CUDA C++ for sm_90a with a plain C entry per kernel,
                   built with nvcc at first use and loaded with ctypes
                   (``_build``); csrc/bisect.cuh holds the bisections
                   they share
- sorted_probe   — equal-range probe of query keys into one sorted key
                   column: one thread per query, two bisections
- run_probe      — rank + membership of targets within per-row sorted
                   runs: one thread per row, one bisection
- delta_probe    — the live store's delta half of a merged probe: insert
                   equal range + tombstone ranks, one thread per query
- ref            — plain PyTorch versions (the CPU path and the kernels'
                   ground truth)
- ops            — THE dispatch layer: a CUDA tensor runs the kernel, a
                   CPU tensor the plain version; nothing else decides.
"""
