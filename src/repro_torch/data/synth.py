"""Synthetic batches matching ``configs.registry.input_specs``: the LM
branch of the JAX package's ``repro.data.synth``, drawn with the same
``np.random.default_rng(seed)`` calls, so the values are the reference's
bit for bit.  Host tensors; the caller moves them to its device.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import registry as R


def make_batch(arch: str, shape: str, smoke: bool = True, seed: int = 0
               ) -> dict:
    """``{"tokens": int32 [B, S]}`` for train and prefill shapes;
    ``{"token": int32 [B], "cache": {"k", "v": float32 [L, B, n_kv, S, D]}}``
    (normal times 0.02) for decode shapes."""
    rng = np.random.default_rng(seed)
    cfg = R.model_config_for(arch, shape, smoke)
    specs = R.input_specs(arch, shape, smoke)
    if "tokens" in specs:
        return {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, tuple(specs["tokens"].shape)).astype(np.int32))}
    out = {"token": torch.from_numpy(rng.integers(
        0, cfg.vocab, tuple(specs["token"].shape)).astype(np.int32))}
    out["cache"] = {
        k: torch.from_numpy((rng.normal(size=tuple(s.shape)) * 0.02
                             ).astype(np.float32))
        for k, s in specs["cache"].items()}
    return out
