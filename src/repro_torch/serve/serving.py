"""Serving layer: batched prefill and KV-cache decode of the dense LM.

The GQA cache is ``k``/``v`` ``[L, B, n_kv, S, D]``, preallocated at the
full context and filled in place by ``Transformer.decode_step``.  The
reference's cache sharding over a device mesh (``cache_specs``) and the
MoE family come with slice 7b of the port.
"""

from __future__ import annotations

from typing import Any, Callable

from repro_torch.models import transformer as tfm_mod


def _lm_only(family: str) -> None:
    if family != "lm":
        raise NotImplementedError(f"serving family {family!r} comes with "
                                  f"slice 7b of the port; only 'lm' is "
                                  f"ported")


def make_decode_step(family: str, cfg: Any) -> Callable:
    """``step(model, token, cache, pos) -> (logits, cache)``."""
    _lm_only(family)
    return tfm_mod.Transformer.decode_step


def make_prefill(family: str, cfg: Any) -> Callable:
    """Prefill = the forward pass producing logits:
    ``fn(model, tokens) -> logits``."""
    _lm_only(family)
    return lambda model, tokens: model(tokens)
