"""The sorted probe: equal range of query keys in one sorted key column.

``sorted_probe_cuda`` launches the CUDA kernel ``csrc/sorted_probe.cu``
(one thread per query, two bisections sharing their prefix), which
replaces the Pallas kernel ``repro/kernels/sorted_probe.py::
sorted_probe_pallas``.  ``sorted_probe_plain`` is the same function in
plain PyTorch (``torch.searchsorted``), the CPU path and the kernel's
ground truth.  Both return ``(rank_lo, rank_hi, contains)``:

    rank_lo[i]  = #{k in keys : k <  queries[i]}   (searchsorted "left")
    rank_hi[i]  = #{k in keys : k <= queries[i]}   (searchsorted "right")
    contains[i] = rank_lo[i] < rank_hi[i]

int32, int32 and bool.  ``ops.eqrange``, ``ops.sorted_probe`` and
``ops.searchsorted`` are three views of this one kernel.  It takes two
width pairs: int64 keys with int64 queries (the packed key columns and
the expansion's cumulative degrees) and int32 keys with int32 queries
(the live store's tombstone rank searches, base positions against the
int32 tombstone columns).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def sorted_probe_plain(keys: torch.Tensor, queries: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device."""
    lo, hi = ref.eqrange_ref(keys, queries)
    return lo, hi, lo < hi


_KEY_BITS = {torch.int64: 64, torch.int32: 32}


def _entry():
    fn = _build.library("sorted_probe").sorted_probe_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, ll, p, ll, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def sorted_probe_cuda(keys: torch.Tensor, queries: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA sorted probe on ``keys`` (sorted ascending) and
    ``queries``: contiguous 1-D tensors on one CUDA device, both int64 or
    both int32, with fewer than 2^31 keys.  Raises on anything else, on a
    failed build and on a failed launch."""
    for name, t in (("keys", keys), ("queries", queries)):
        if not t.is_cuda or t.device != keys.device:
            raise ValueError(f"{name} must be on the keys' CUDA device, "
                             f"got {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, "
                             f"got shape {tuple(t.shape)}")
    if keys.dtype != queries.dtype or keys.dtype not in _KEY_BITS:
        raise ValueError(f"keys and queries must be int64 x int64 or "
                         f"int32 x int32, got {keys.dtype} x "
                         f"{queries.dtype}")
    n, q = keys.shape[0], queries.shape[0]
    if n >= 2**31:
        raise ValueError(f"sorted_probe takes fewer than 2^31 keys, got {n}")
    dev = keys.device
    rank_lo = torch.empty(q, dtype=torch.int32, device=dev)
    rank_hi = torch.empty(q, dtype=torch.int32, device=dev)
    contains = torch.empty(q, dtype=torch.bool, device=dev)
    if q == 0:
        return rank_lo, rank_hi, contains
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(keys.data_ptr(), _KEY_BITS[keys.dtype], n,
                  queries.data_ptr(), q, rank_lo.data_ptr(),
                  rank_hi.data_ptr(), contains.data_ptr(), stream)
    _build.check("sorted_probe", code)
    _build.LAUNCHES["sorted_probe"] += 1
    return rank_lo, rank_hi, contains
