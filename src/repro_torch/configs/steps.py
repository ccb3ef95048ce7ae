"""Step builders: (arch, shape) -> the function the cell runs.

Cell kinds of the LM family:
- ``prefill``  batched forward over the full sequence: ``fn(model,
  batch)`` with ``batch = {"tokens": [B, S]}`` -> logits ``[B, S, V]``;
- ``decode``   one-token decode against a filled KV cache: ``fn(model,
  token, cache)`` -> ``(logits [B, V], cache)``, at the cache's last
  position.
``train`` cells are slice 7b of the port (the optimizer, the trainer and
attention's backward), and ``build_cell`` raises for them.

The model is the first argument: in PyTorch the parameters live in the
module, so ``arg_specs`` holds the ``meta`` specs of the other inputs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

from repro_torch.configs import registry as R
from repro_torch.serve import serving


@dataclass
class CellSpec:
    arch: str
    shape: str
    kind: str
    fn: Callable  # (model, inputs...) -> outputs
    arg_specs: tuple  # meta tensors of the inputs after the model
    model_cfg: Any
    family: str


def build_cell(arch: str, shape: str, smoke: bool = False,
               overrides: dict | None = None) -> CellSpec:
    """The cell of (arch, shape); ``overrides`` replaces config fields
    (names the config lacks are ignored, as in the reference)."""
    e = R.get(arch)
    cfg = R.model_config_for(arch, shape, smoke)
    if overrides:
        valid = {k: v for k, v in overrides.items() if hasattr(cfg, k)}
        cfg = replace(cfg, **valid)
    specs = R.input_specs(arch, shape, smoke)
    kind = R.shape_defs(arch, smoke)[shape]["kind"]

    if kind == "train":
        raise NotImplementedError(
            f"{arch} {shape}: train cells come with slice 7b of the port "
            f"(optimizer, trainer, attention's backward)")

    if kind == "prefill":
        prefill = serving.make_prefill(e.family, cfg)

        def step(model, batch):
            return prefill(model, batch["tokens"])

        return CellSpec(arch, shape, "prefill", step, (specs,), cfg,
                        e.family)

    if kind == "decode":
        pos = cache_len(specs) - 1
        decode = serving.make_decode_step(e.family, cfg)

        def step(model, token, cache):
            return decode(model, token, cache, pos)

        return CellSpec(arch, shape, "decode", step,
                        (specs["token"], specs["cache"]), cfg, e.family)

    raise ValueError(kind)


def cache_len(specs: dict) -> int:
    return specs["cache"]["k"].shape[3]


def all_cells() -> list[tuple[str, str]]:
    return [(arch, shape) for arch in R.all_archs()
            for shape in R.get(arch).shapes]
