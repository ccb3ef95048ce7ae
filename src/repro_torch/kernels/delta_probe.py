"""The delta probe: the merged base+delta probe's delta half.

``delta_probe_cuda`` launches the CUDA kernel ``csrc/delta_probe.cu`` (one
thread per query: an equal range in the insert keys and two lower bounds
in the tombstone positions), which replaces the Pallas kernel
``repro/kernels/delta_probe.py::delta_probe_pallas``.
``delta_probe_plain`` is the same function in plain PyTorch (four
``torch.searchsorted`` ranks), the CPU path and the kernel's ground
truth.  Both return ``(ins_lo, ins_hi, tomb_lo, tomb_hi)``, int32:

    ins_lo[i]  = #{k in ins_keys : k <  query_keys[i]}
    ins_hi[i]  = #{k in ins_keys : k <= query_keys[i]}
    tomb_lo[i] = #{p in tomb_pos : p <  base_lo[i]}
    tomb_hi[i] = #{p in tomb_pos : p <  base_hi[i]}

``query_keys`` are the keys a base ``eqrange`` just probed and
``[base_lo, base_hi)`` its result, so the insert run to merge in is
``[ins_lo, ins_hi)`` and ``tomb_hi - tomb_lo`` of the base run are dead.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def delta_probe_plain(ins_keys: torch.Tensor, tomb_pos: torch.Tensor,
                      query_keys: torch.Tensor, base_lo: torch.Tensor,
                      base_hi: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device."""
    return ref.delta_probe_ref(ins_keys, tomb_pos, query_keys, base_lo,
                               base_hi)


def _entry():
    fn = _build.library("delta_probe").delta_probe_launch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, ll, p, ll, p, p, p, ll, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def delta_probe_cuda(ins_keys: torch.Tensor, tomb_pos: torch.Tensor,
                     query_keys: torch.Tensor, base_lo: torch.Tensor,
                     base_hi: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Launch the CUDA delta probe.  ``ins_keys``: int64 sorted
    ascending; ``tomb_pos``: int32 sorted ascending; ``query_keys``:
    int64; ``base_lo``/``base_hi``: int32, each as long as
    ``query_keys``.  All contiguous 1-D tensors on one CUDA device, the
    columns shorter than 2^31.  Raises on anything else, on a failed
    build and on a failed launch."""
    dev = ins_keys.device
    q = query_keys.shape[0]
    for name, t, dt in (("ins_keys", ins_keys, torch.int64),
                        ("tomb_pos", tomb_pos, torch.int32),
                        ("query_keys", query_keys, torch.int64),
                        ("base_lo", base_lo, torch.int32),
                        ("base_hi", base_hi, torch.int32)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name} must be on the insert keys' CUDA "
                             f"device, got {t.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor, "
                             f"got shape {tuple(t.shape)}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if name.startswith("base") and t.shape[0] != q:
            raise ValueError(f"{name} has {t.shape[0]} entries, query_keys "
                             f"has {q}")
    m, t = ins_keys.shape[0], tomb_pos.shape[0]
    if m >= 2**31 or t >= 2**31:
        raise ValueError(f"delta_probe takes columns shorter than 2^31, "
                         f"got {m} and {t}")
    out = [torch.empty(q, dtype=torch.int32, device=dev) for _ in range(4)]
    if q == 0:
        return tuple(out)
    fn = _entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(ins_keys.data_ptr(), m, tomb_pos.data_ptr(), t,
                  query_keys.data_ptr(), base_lo.data_ptr(),
                  base_hi.data_ptr(), q, *(o.data_ptr() for o in out),
                  stream)
    _build.check("delta_probe", code)
    _build.LAUNCHES["delta_probe"] += 1
    return tuple(out)
