"""The wave fingerprint: a 4 x uint32 digest of each lane's valid rows.

``fingerprint_rows_cuda`` launches the CUDA kernel
``csrc/fingerprint_rows.cu`` (one thread per row, warp shuffles and one
atomic per warp and salt into a per-lane accumulator, then a finalize
launch), which replaces the Pallas kernel
``repro/kernels/fingerprint.py::fingerprint_rows_pallas``.
``fingerprint_rows_plain`` is the same function in plain PyTorch
(``ref.fingerprint_rows_ref``, int64 arithmetic masked to 32 bits), the
CPU path and the kernel's ground truth; ``ref.fingerprint_prefix_np`` is
its numpy twin on a bare valid prefix.

Both take a wave ``int32[B, n, C]`` with validity ``bool[B, n]`` (the
plain version also one lane, ``[n, C]`` with ``[n]``, as the reference's
function does) and return int64 ``[B, 4]`` holding the digests' unsigned
values — the integers the scheduler puts in its cache keys, equal to the
JAX reference's.  The valid rows need not be a prefix; a zero-column
block hashes every valid row from the seed alone.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref


def fingerprint_rows_plain(block: torch.Tensor, valid: torch.Tensor
                           ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    return ref.fingerprint_rows_ref(block, valid)


def _entry():
    fn = _build.library("fingerprint_rows").fingerprint_rows_launch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, ll, ll, ll, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def fingerprint_rows_cuda(block: torch.Tensor, valid: torch.Tensor
                          ) -> torch.Tensor:
    """Launch the CUDA fingerprint.  ``block``: contiguous int32
    ``[B, n, C]`` (``B < 2^16``); ``valid``: contiguous bool ``[B, n]``,
    on the block's CUDA device.  Raises on anything else, on a failed
    build and on a failed launch."""
    if not block.is_cuda or not valid.is_cuda or valid.device != block.device:
        raise ValueError(f"block and valid must be on one CUDA device, got "
                         f"{block.device} and {valid.device}")
    if block.dtype != torch.int32:
        raise ValueError(f"block must be torch.int32, got {block.dtype}")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be torch.bool, got {valid.dtype}")
    if block.dim() != 3 or valid.shape != block.shape[:-1]:
        raise ValueError(f"block must be [B, n, C] with valid [B, n], got "
                         f"{tuple(block.shape)} and {tuple(valid.shape)}")
    if not block.is_contiguous() or not valid.is_contiguous():
        raise ValueError("block and valid must be contiguous")
    lanes, n, n_cols = block.shape
    if lanes >= 2**16:
        raise ValueError(f"fingerprint_rows takes fewer than 2^16 lanes, "
                         f"got {lanes}")
    dev = block.device
    acc = torch.zeros((lanes, 5), dtype=torch.int32, device=dev)
    out = torch.empty((lanes, 4), dtype=torch.int32, device=dev)
    if lanes:
        fn = _entry()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            code = fn(block.data_ptr(), valid.data_ptr(), lanes, n, n_cols,
                      acc.data_ptr(), out.data_ptr(), stream)
        _build.check("fingerprint_rows", code)
        _build.LAUNCHES["fingerprint_rows"] += 1
    return out.to(torch.int64) & 0xFFFFFFFF
