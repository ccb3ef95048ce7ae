"""Architecture registry: the LM family of the JAX package's registry.

Each entry provides:
- ``full``   — the exact published configuration;
- ``smoke``  — a reduced same-family config for CPU tests;
- ``family`` — "lm" (the only family ported; the MoE, GNN and recsys
  entries of the reference come with their models);
- ``shapes`` — the arch's own input-shape set.

``input_specs(arch, shape, smoke=False)`` returns ``meta``-device tensors
for every step input: shapes and dtypes, no storage.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.models.transformer import TransformerConfig


@dataclass(frozen=True)
class ArchEntry:
    name: str
    family: str
    full: Any
    smoke: Any
    shapes: tuple[str, ...]
    source: str  # provenance tag


_REGISTRY: dict[str, ArchEntry] = {}


def register(entry: ArchEntry) -> ArchEntry:
    _REGISTRY[entry.name] = entry
    return entry


def get(name: str) -> ArchEntry:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_archs() -> list[str]:
    return sorted(_REGISTRY)


# ======================================================================= LM
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

register(ArchEntry(
    name="glm4-9b", family="lm",
    full=TransformerConfig(
        name="glm4-9b", n_layers=40, d_model=4096, n_heads=32, n_kv=2,
        head_dim=128, d_ff=13696, vocab=151552, act="swiglu", qkv_bias=True,
        rope_fraction=0.5, rope_theta=10000.0),
    smoke=TransformerConfig(
        name="glm4-9b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=2,
        head_dim=16, d_ff=128, vocab=256, act="swiglu", qkv_bias=True,
        rope_fraction=0.5, remat=False),
    shapes=LM_SHAPES, source="hf:THUDM/glm-4-9b; hf"))

register(ArchEntry(
    name="gemma-7b", family="lm",
    full=TransformerConfig(
        name="gemma-7b", n_layers=28, d_model=3072, n_heads=16, n_kv=16,
        head_dim=256, d_ff=24576, vocab=256000, act="geglu", qkv_bias=False,
        tie_embeddings=True, scale_embeddings=True),
    smoke=TransformerConfig(
        name="gemma-7b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv=4,
        head_dim=16, d_ff=192, vocab=256, act="geglu", tie_embeddings=True,
        scale_embeddings=True, remat=False),
    shapes=LM_SHAPES, source="arXiv:2403.08295; hf"))

register(ArchEntry(
    name="qwen2-7b", family="lm",
    full=TransformerConfig(
        name="qwen2-7b", n_layers=28, d_model=3584, n_heads=28, n_kv=4,
        head_dim=128, d_ff=18944, vocab=152064, act="swiglu", qkv_bias=True,
        rope_theta=1000000.0),
    smoke=TransformerConfig(
        name="qwen2-7b-smoke", n_layers=2, d_model=56, n_heads=4, n_kv=2,
        head_dim=14, d_ff=112, vocab=256, act="swiglu", qkv_bias=True,
        remat=False),
    shapes=LM_SHAPES, source="arXiv:2407.10671; hf"))


LM_SHAPE_DEFS = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
}
LM_SMOKE_SHAPE_DEFS = {
    "train_4k": dict(kind="train", seq=64, batch=4),
    "prefill_32k": dict(kind="prefill", seq=128, batch=2),
    "decode_32k": dict(kind="decode", seq=128, batch=4),
    "long_500k": dict(kind="decode", seq=256, batch=1, long=True),
}


# ============================================================= input specs

def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def shape_defs(arch: str, smoke: bool = False) -> dict:
    get(arch)
    return LM_SMOKE_SHAPE_DEFS if smoke else LM_SHAPE_DEFS


def input_specs(arch: str, shape: str, smoke: bool = False) -> dict:
    """``meta`` tensors standing in for the step inputs of (arch, shape)."""
    cfg = model_config_for(arch, shape, smoke)
    defs = shape_defs(arch, smoke)[shape]
    if defs["kind"] in ("train", "prefill"):
        return {"tokens": _spec((defs["batch"], defs["seq"]), torch.int32)}
    # decode: one new token against a filled cache
    kv = (cfg.n_layers, defs["batch"], cfg.n_kv, defs["seq"], cfg.head_dim)
    return {"token": _spec((defs["batch"],), torch.int32),
            "cache": {"k": _spec(kv, torch.bfloat16),
                      "v": _spec(kv, torch.bfloat16)}}


def model_config_for(arch: str, shape: str, smoke: bool = False) -> Any:
    """The arch's config for a shape (an LM's does not depend on it)."""
    e = get(arch)
    return e.smoke if smoke else e.full
