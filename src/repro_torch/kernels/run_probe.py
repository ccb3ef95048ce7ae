"""The run probe: rank and membership of targets within per-row sorted runs.

``run_probe_cuda`` launches the CUDA kernel ``csrc/run_probe.cu`` (one
thread per row, one bisection of ``values[lo:hi)``), which replaces both
Pallas variants ``repro/kernels/run_probe.py::run_probe_prefetch_pallas``
(the default) and ``run_probe_pallas`` (the dense one): they compute the
same function and differed only in which tiles a TPU streams.
``run_probe_plain`` is the same function in plain PyTorch (a fixed-count
bisection loop, as the reference oracle), the CPU path and the kernel's
ground truth.  Both return ``(pos, contains)``:

    pos[i]      = lo[i] + #{k in [lo[i], hi[i]) : values[k] < targets[i]}
    contains[i] = targets[i] occurs in values[lo[i]:hi[i]]

int32 and bool; an empty run gives ``(lo, False)``.  An int32 value
column is compared with int64 targets in the kernel's registers: no
promoted copy of the column is made.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_VALUE_BITS = {torch.int32: 32, torch.int64: 64}


def run_probe_plain(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device."""
    return ref.run_probe_ref(values, lo, hi, targets)


def _entry():
    fn = _build.library("run_probe").run_probe_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, i, ll, p, p, p, ll, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def run_probe_cuda(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                   targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA run probe.  ``values``: contiguous 1-D int32/int64
    on a CUDA device, fewer than 2^31 entries; ``lo``/``hi``: int32 run
    bounds inside ``[0, len(values)]`` (the kernel reads
    ``values[lo:hi)`` unchecked — the store's eqrange produces them);
    ``targets``: int64.  ``lo``, ``hi`` and ``targets`` are
    contiguous 1-D tensors of one length on the same device.  Raises on
    anything else, on a failed build and on a failed launch."""
    dev = values.device
    r = lo.shape[0]
    for name, t in (("values", values), ("lo", lo), ("hi", hi),
                    ("targets", targets)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on the values' CUDA device, "
                             f"got {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, "
                             f"got shape {tuple(t.shape)}")
        if name != "values" and t.shape[0] != r:
            raise ValueError(f"{name} has {t.shape[0]} rows, lo has {r}")
    if values.dtype not in _VALUE_BITS:
        raise ValueError(f"values must be int32 or int64, got {values.dtype}")
    if lo.dtype != torch.int32 or hi.dtype != torch.int32:
        raise ValueError("lo and hi must be int32 run bounds")
    if targets.dtype != torch.int64:
        raise ValueError(f"targets must be int64, got {targets.dtype}")
    n = values.shape[0]
    if n >= 2**31:
        raise ValueError(f"run_probe takes fewer than 2^31 values, got {n}")
    pos = torch.empty(r, dtype=torch.int32, device=dev)
    contains = torch.empty(r, dtype=torch.bool, device=dev)
    if r == 0:
        return pos, contains
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(values.data_ptr(), _VALUE_BITS[values.dtype], n,
                  lo.data_ptr(), hi.data_ptr(), targets.data_ptr(), r,
                  pos.data_ptr(), contains.data_ptr(), stream)
    _build.check("run_probe", code)
    _build.LAUNCHES["run_probe"] += 1
    return pos, contains
