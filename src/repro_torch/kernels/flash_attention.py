"""Attention forward: online softmax, optional causal mask, GQA.

``flash_attention_cuda`` launches the CUDA kernel
``csrc/flash_attention.cu`` (one CTA per batch x query head and block of
64 query rows, K and V tiles staged in shared memory, the online softmax
in registers, f32 FMAs on CUDA cores), which replaces the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``.
``flash_attention_plain`` is the same function in plain PyTorch, the
JAX reference's non-TPU split: ``ref.attention_chunked`` when
``Sk >= 2048``, else ``ref.attention_ref`` — the CPU path and the
kernel's ground truth.

Both take q ``[B, Hq, Sq, D]`` and k, v ``[B, Hkv, Sk, D]`` with
``Hq % Hkv == 0`` (query head ``h`` reads KV head ``h // (Hq // Hkv)``),
any strides, and return ``[B, Hq, Sq, D]`` in q's dtype; ``scale``
defaults to ``1/sqrt(D)`` and the causal mask is top-left aligned.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: The input types the kernel takes: its callers' and its tests'.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    if k.shape[2] >= 2048:
        return ref.attention_chunked(q, k, v, causal=causal, scale=scale)
    return ref.attention_ref(q, k, v, causal=causal, scale=scale)


def _entry():
    fn = _build.library("flash_attention").flash_attention_launch
    if fn.argtypes is None:
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, ll, ll, ll, ll, ll, ll, p,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: float | None = None
                         ) -> torch.Tensor:
    """Launch the CUDA attention kernel.  q, k, v: 4-d float32 or bfloat16
    tensors of one type on one CUDA device, any strides, with
    ``Hq % Hkv == 0``, one head dim ``D <= 256`` and ``Sk >= 1``.  Raises on
    anything else, on a failed build and on a failed launch."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (
            q.device == k.device == v.device):
        raise ValueError(f"q, k and v must be on one CUDA device, got "
                         f"{q.device}, {k.device} and {v.device}")
    if q.dtype not in DTYPES or not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k and v must all be torch.float32 or all "
                         f"torch.bfloat16, got {q.dtype}, {k.dtype} and "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Hq, Sq, D] and k, v [B, Hkv, Sk, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, sk, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"k and v must match q's batch and head dim, got q "
                         f"{tuple(q.shape)} and k {tuple(k.shape)}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq must be a multiple of Hkv, got {hq} and {hkv}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in [1, {MAX_HEAD_DIM}], got {d}")
    if sk < 1:
        raise ValueError("attention needs at least one key (Sk >= 1)")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if b and hq and sq:
        strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(),
                                           *v.stride())
        fn = _entry()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), b, hq, hkv, sq, sk, d,
                      ctypes.cast(strides, ctypes.c_void_p), float(scale),
                      int(bool(causal)), DTYPES[q.dtype], stream)
        _build.check("flash_attention", code)
        _build.LAUNCHES["flash_attention"] += 1
    return out
