"""The owner-masked probe: ``eqrange`` fused with subject-hash ownership.

``eqrange_owned_cuda`` launches the CUDA kernel ``csrc/eqrange_owned.cu``
(one thread per query row: a splitmix64 of its subject in uint64, then a
lower-bound bisection, and the upper one only for an owned row), which
replaces the Pallas kernel ``repro/kernels/owned_probe.py::
eqrange_owned_pallas``.  ``eqrange_owned_plain`` is the same function in
plain PyTorch (``ref.subject_shard_ref`` and two ``torch.searchsorted``
ranks), the CPU path and the kernel's ground truth.  Both return
``(lo, hi, owned)``:

    owned[i] = ref.subject_shard_ref(subjects[i], n_shards) == my_shard
    lo[i]    = #{k in keys : k <  queries[i]}
    hi[i]    = #{k in keys : k <= queries[i]} if owned[i] else lo[i]

int32, int32 and bool.  On a subject-hash-sharded store a row can match
only on the shard its subject hashes to, so every other shard hands it
the empty run ``[lo, lo)``.  Unlike the reference's limb-wise fold,
neither path bounds ``n_shards`` above.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def eqrange_owned_plain(keys: torch.Tensor, queries: torch.Tensor,
                        subjects: torch.Tensor, my_shard: int,
                        n_shards: int
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device."""
    return ref.eqrange_owned_ref(keys, queries, subjects, my_shard, n_shards)


def _entry():
    fn = _build.library("eqrange_owned").eqrange_owned_launch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, ll, p, p, ll, ll, ll, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def eqrange_owned_cuda(keys: torch.Tensor, queries: torch.Tensor,
                       subjects: torch.Tensor, my_shard: int, n_shards: int
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the CUDA owner-masked probe on ``keys`` (sorted ascending,
    fewer than 2^31), ``queries`` and ``subjects`` (one per query): int64
    contiguous 1-D tensors on one CUDA device; ``n_shards >= 1``.  Raises
    on anything else, on a failed build and on a failed launch."""
    dev = keys.device
    for name, t in (("keys", keys), ("queries", queries),
                    ("subjects", subjects)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on the keys' CUDA device, "
                             f"got {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != torch.int64:
            raise ValueError(f"{name} must be int64, got {t.dtype}")
    n, q = keys.shape[0], queries.shape[0]
    if subjects.shape[0] != q:
        raise ValueError(f"subjects has {subjects.shape[0]} entries, "
                         f"queries has {q}")
    if n >= 2**31:
        raise ValueError(f"eqrange_owned takes fewer than 2^31 keys, got {n}")
    n_shards, my_shard = int(n_shards), int(my_shard)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    rank_lo = torch.empty(q, dtype=torch.int32, device=dev)
    rank_hi = torch.empty(q, dtype=torch.int32, device=dev)
    owned = torch.empty(q, dtype=torch.bool, device=dev)
    if q == 0:
        return rank_lo, rank_hi, owned
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(keys.data_ptr(), n, queries.data_ptr(),
                  subjects.data_ptr(), q, my_shard, n_shards,
                  rank_lo.data_ptr(), rank_hi.data_ptr(), owned.data_ptr(),
                  stream)
    _build.check("eqrange_owned", code)
    _build.LAUNCHES["eqrange_owned"] += 1
    return rank_lo, rank_hi, owned
