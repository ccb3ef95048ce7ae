"""Hand-written Hopper kernels for the SPF engine, the scheduler and the
model stack, and their seam.

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
- owned_probe    — the sharded store's owner-masked probe: a uint64
                   splitmix64 of the row's subject, then the equal range
                   (only the lower bound for a row another shard owns),
                   one thread per query
- fingerprint    — the scheduler's wave digest: a 4 x uint32 hash of each
                   lane's valid rows, one thread per row, warp shuffles
                   and atomics into a per-lane accumulator
- replay         — the scheduler's cache-hit replay: cached deltas
                   gathered onto the lanes' seed tables, one thread per
                   output element
- flash_attention — attention forward for the transformer, two kernels
                   picked by a rule on the operands (``wgmma_eligible``):
                   csrc/flash_attention_wgmma.cu for bf16 operands TMA can
                   load (D 64 / 128 / 256) — wgmma on tiles TMA brings
                   into a ring in shared memory, one CTA per batch x query
                   head and block of 128 query rows; csrc/flash_attention.cu
                   for the rest — K/V tiles in shared memory, f32 FMAs on
                   CUDA cores; both keep the online softmax in registers
- ref            — plain PyTorch versions (the CPU path and the kernels'
                   ground truth)
- ops            — THE dispatch layer: a CUDA tensor runs the kernel, a
                   CPU tensor the plain version; nothing else decides.
"""
