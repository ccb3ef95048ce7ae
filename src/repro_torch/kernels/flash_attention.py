"""Attention forward: online softmax, optional causal mask, GQA.

Two hand-written CUDA kernels replace the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_pallas``, and
``flash_attention_cuda`` picks one by a rule about the operands,
``wgmma_eligible``, and by nothing else:

- ``csrc/flash_attention_wgmma.cu`` (``flash_attention_wgmma_cuda``) for
  bfloat16 operands that TMA can load: D in {64, 128, 256}, a unit stride
  on D, 16-byte-aligned bases, every other stride a multiple of 8
  elements.  Hopper tensor cores (wgmma on bf16 tiles TMA brings into
  shared memory), P fed to the P V product as a hi + lo pair of bf16
  values so that product keeps f32's precision.  The layers' transposed
  views of ``[B, S, H, D]`` meet the rule at D 128 and 256.
- ``csrc/flash_attention.cu`` (``flash_attention_simple_cuda``) for
  everything else: float32 (wgmma would take it only as TF32), head dims
  that are not 64, 128 or 256, and misaligned views.  f32 FMAs on CUDA
  cores, any strides, any D <= 256.

A failed build or launch of either raises; neither stands in for the
other.  ``flash_attention_plain`` is the same function in plain PyTorch,
the JAX reference's non-TPU split: ``ref.attention_chunked`` when
``Sk >= 2048``, else ``ref.attention_ref`` — the CPU path and both
kernels' ground truth.

All take q ``[B, Hq, Sq, D]`` and k, v ``[B, Hkv, Sk, D]`` with
``Hq % Hkv == 0`` (query head ``h`` reads KV head ``h // (Hq // Hkv)``)
and return a contiguous ``[B, Hq, Sq, D]`` in q's dtype; ``scale``
defaults to ``1/sqrt(D)`` and the causal mask is top-left aligned.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

#: The input types the simple kernel takes: its callers' and its tests'.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
#: The head dims the wgmma kernel is built for (whole 64-column TMA boxes).
WGMMA_HEAD_DIMS = (64, 128, 256)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, scale: float | None = None
                          ) -> torch.Tensor:
    """The kernels' function in plain PyTorch, on any device."""
    if k.shape[2] >= 2048:
        return ref.attention_chunked(q, k, v, causal=causal, scale=scale)
    return ref.attention_ref(q, k, v, causal=causal, scale=scale)


def wgmma_eligible(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> bool:
    """True where the wgmma kernel takes the operands (TMA's rules): all
    three bfloat16 and 4-d with a head dim in ``WGMMA_HEAD_DIMS``, a unit
    stride on it, a base aligned to 16 bytes, and the stride of every
    other dimension longer than 1 a positive multiple of 8 elements.  A
    pure function of dtypes, shapes, strides and base addresses, on any
    device."""
    for t in (q, k, v):
        if (t.dtype != torch.bfloat16 or t.dim() != 4
                or t.shape[-1] not in WGMMA_HEAD_DIMS or t.stride(-1) != 1
                or t.data_ptr() % 16):
            return False
        if any(n > 1 and (s <= 0 or s % 8)
               for n, s in zip(t.shape[:-1], t.stride()[:-1])):
            return False
    return True


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           dtypes) -> None:
    """Raise unless q, k, v are attention operands on one CUDA device with
    one of ``dtypes``."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not (
            q.device == k.device == v.device):
        raise ValueError(f"q, k and v must be on one CUDA device, got "
                         f"{q.device}, {k.device} and {v.device}")
    if q.dtype not in dtypes or not q.dtype == k.dtype == v.dtype:
        names = " or all ".join(str(d) for d in dtypes)
        raise ValueError(f"q, k and v must all be {names}, got {q.dtype}, "
                         f"{k.dtype} and {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be [B, Hq, Sq, D] and k, v [B, Hkv, Sk, D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
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


def _launch(name: str, argtypes, q, k, v, causal, scale, *extra):
    """Allocate the output and launch kernel ``name`` (counted) where there
    is work."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if not (b and hq and sq):
        return out
    fn = getattr(_build.library(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 12)(*q.stride(), *k.stride(), *v.stride())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, hq, hkv, sq, sk, d, ctypes.cast(strides, ctypes.c_void_p),
                  float(1.0 / d ** 0.5 if scale is None else scale),
                  int(bool(causal)), *extra, stream)
    _build.check(name, code)
    _build.LAUNCHES[name] += 1
    return out


_P, _LL = ctypes.c_void_p, ctypes.c_longlong
_HEAD = [_P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _LL, _P, ctypes.c_float,
         ctypes.c_int]


def flash_attention_simple_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, causal: bool = True,
                                scale: float | None = None) -> torch.Tensor:
    """Launch the simple CUDA attention kernel (``csrc/flash_attention.cu``).
    q, k, v: 4-d float32 or bfloat16 tensors of one type on one CUDA
    device, any strides, with ``Hq % Hkv == 0``, one head dim
    ``D <= 256`` and ``Sk >= 1``.  Raises on anything else, on a failed
    build and on a failed launch."""
    _check(q, k, v, DTYPES)
    return _launch("flash_attention", _HEAD + [ctypes.c_int, _P], q, k, v,
                   causal, scale, DTYPES[q.dtype])


def flash_attention_wgmma_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, causal: bool = True,
                               scale: float | None = None) -> torch.Tensor:
    """Launch the wgmma attention kernel (``csrc/flash_attention_wgmma.cu``).
    q, k, v: bfloat16 attention operands on one CUDA device that
    ``wgmma_eligible`` admits, with ``Hq % Hkv == 0`` and ``Sk >= 1``.
    Raises on anything else, on a failed build and on a failed launch."""
    _check(q, k, v, (torch.bfloat16,))
    if not wgmma_eligible(q, k, v):
        raise ValueError(
            f"the wgmma kernel takes head dims {WGMMA_HEAD_DIMS} with a unit "
            f"stride, 16-byte-aligned bases and other strides multiples of "
            f"8 elements; got shapes {tuple(q.shape)}, {tuple(k.shape)}, "
            f"strides {q.stride()}, {k.stride()}, {v.stride()}")
    return _launch("flash_attention_wgmma", _HEAD + [_P], q, k, v, causal,
                   scale)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True, scale: float | None = None
                         ) -> torch.Tensor:
    """Attention on the card: the wgmma kernel where ``wgmma_eligible``
    holds, the simple kernel everywhere else (the module's docstring).
    Raises as the chosen kernel's wrapper does."""
    if wgmma_eligible(q, k, v):
        return flash_attention_wgmma_cuda(q, k, v, causal=causal, scale=scale)
    return flash_attention_simple_cuda(q, k, v, causal=causal, scale=scale)
