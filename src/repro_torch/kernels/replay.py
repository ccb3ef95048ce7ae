"""The cache-hit replay: cached fragment deltas onto the lanes' seeds.

``replay_delta_cuda`` launches the CUDA kernel ``csrc/replay_delta.cu``
(a plain row gather, one thread per output element, into a fresh
table), which replaces the Pallas kernel ``repro/kernels/replay.py::
replay_delta_pallas``.  ``replay_delta_plain`` is the same function in
plain PyTorch (``ref.replay_delta_ref``), the CPU path and the kernel's
ground truth; ``core.fragcache.replay`` is its numpy twin.

Both take a wave's seed tables ``int32[B, cap, V]``, the deltas' source
rows ``int32[B, M]`` (``M <= cap``), their write-column values
``int32[B, M, W]``, the output counts ``int32[B]`` and the unit's
``write_cols`` (``W`` distinct columns) — the plain version also one
lane without the lane axis, as the reference's function — and return
``(rows, valid)``: row ``j < n_out`` is the seed row ``src[j]`` with the
write columns overwritten by ``written[j]``, the rest UNBOUND, and the
valid rows are the prefix ``n_out``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

MAX_VARS = 64  # the widest table the kernel's column map holds


def replay_delta_plain(seed_rows: torch.Tensor, src: torch.Tensor,
                       written: torch.Tensor, n_out: torch.Tensor,
                       write_cols: tuple[int, ...]
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch, on any device."""
    return ref.replay_delta_ref(seed_rows, src, written, n_out, write_cols)


def _entry():
    fn = _build.library("replay_delta").replay_delta_launch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, ll, ll, ll, ll,
                       ctypes.POINTER(ctypes.c_int), p, p, p]
        fn.restype = ctypes.c_int
    return fn


def replay_delta_cuda(seed_rows: torch.Tensor, src: torch.Tensor,
                      written: torch.Tensor, n_out: torch.Tensor,
                      write_cols: tuple[int, ...]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA replay.  ``seed_rows`` int32 ``[B, cap, V]``
    (``1 <= V <= 64``), ``src`` int32 ``[B, M]`` with ``M <= cap``,
    ``written`` int32 ``[B, M, W]``, ``n_out`` int32 ``[B]``, contiguous
    on one CUDA device; ``write_cols`` ``W`` distinct columns in
    ``[0, V)``.  Raises on anything else, on a failed build and on a
    failed launch."""
    for name, t, d in zip(("seed_rows", "src", "written", "n_out"),
                          (seed_rows, src, written, n_out), (3, 2, 3, 1)):
        if not t.is_cuda or t.device != seed_rows.device:
            raise ValueError(f"{name} must be on the seed's CUDA device, "
                             f"got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be torch.int32, got {t.dtype}")
        if t.dim() != d or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {d}-D tensor, "
                             f"got shape {tuple(t.shape)}")
    b, cap, n_vars = seed_rows.shape
    m, n_w = src.shape[1], len(write_cols)
    if src.shape != (b, m) or written.shape != (b, m, n_w) \
            or n_out.shape != (b,):
        raise ValueError(f"src, written and n_out must be [B, M], "
                         f"[B, M, {n_w}] and [B], got {tuple(src.shape)}, "
                         f"{tuple(written.shape)} and {tuple(n_out.shape)}")
    if m > cap or not 1 <= n_vars <= MAX_VARS:
        raise ValueError(f"replay_delta takes M <= cap and 1 <= V <= "
                         f"{MAX_VARS}, got M={m}, cap={cap}, V={n_vars}")
    wmap = [-1] * n_vars
    for w, c in enumerate(write_cols):
        if not 0 <= c < n_vars or wmap[c] != -1:
            raise ValueError(f"write_cols must be distinct columns in "
                             f"[0, {n_vars}), got {tuple(write_cols)}")
        wmap[c] = w
    dev = seed_rows.device
    rows = torch.empty((b, cap, n_vars), dtype=torch.int32, device=dev)
    valid = torch.empty((b, cap), dtype=torch.bool, device=dev)
    if b * cap:
        fn = _entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(seed_rows.data_ptr(), src.data_ptr(),
                      written.data_ptr(), n_out.data_ptr(), b, cap, n_vars,
                      m, n_w, (ctypes.c_int * n_vars)(*wmap),
                      rows.data_ptr(), valid.data_ptr(), stream)
        _build.check("replay_delta", code)
        _build.LAUNCHES["replay_delta"] += 1
    return rows, valid
