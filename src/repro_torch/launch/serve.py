"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>
--shape decode_32k`` — batched greedy decode or a prefill of an LM's
smoke config, on the card (``--device cpu`` for the CPU), as the JAX
package's launcher runs them.

Weights come from a ``torch.Generator`` seeded with 0 on the device, the
tokens and the decode cache from ``data.synth.make_batch``.  A decode
shape runs ``--tokens`` greedy steps from the middle of the cache; a
prefill shape one forward pass, then five timed.  ``chip_smoke.py``'s
phase 8 serves qwen2-7b at its published width and depth through the
same cells and ``greedy_decode``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import registry as R
from repro_torch.configs.steps import build_cell
from repro_torch.data.synth import make_batch
from repro_torch.models.transformer import Transformer
from repro_torch.serve.serving import make_decode_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def greedy_decode(model: Transformer, step, token: torch.Tensor,
                  cache: dict, pos0: int, n_tokens: int
                  ) -> tuple[torch.Tensor, torch.Tensor, float]:
    """``n_tokens`` greedy steps of ``step(model, token, cache, pos)`` from
    position ``pos0``.  Returns (the last token, the last logits, the
    seconds of the synchronised loop)."""
    _sync(model.device)
    t0 = time.perf_counter()
    logits = None
    for i in range(n_tokens):
        logits, cache = step(model, token, cache, pos0 + i)
        token = logits.argmax(dim=-1).to(torch.int32)
    _sync(model.device)
    return token, logits, time.perf_counter() - t0


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tokens", type=int, default=8,
                    help="decode steps to run (LM shapes)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    e = R.get(args.arch)
    cell = build_cell(args.arch, args.shape, smoke=True)
    device = torch.device(args.device)
    where = (f"on the card ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else "on the CPU")
    batch = make_batch(args.arch, args.shape, smoke=True)
    with torch.inference_mode():
        model = Transformer(cell.model_cfg, device=device,
                            generator=torch.Generator(device).manual_seed(0))
        if cell.kind == "decode":
            cache = {k: v.to(device=device, dtype=torch.bfloat16)
                     for k, v in batch["cache"].items()}
            token = batch["token"].to(device)
            step = make_decode_step(e.family, cell.model_cfg)
            token, _, dt = greedy_decode(model, step, token, cache,
                                         cache["k"].shape[3] // 2,
                                         args.tokens)
            print(f"{args.tokens} decode steps, batch {token.shape[0]}: "
                  f"{1e3 * dt / args.tokens:.1f} ms/token {where}")
        else:
            inputs = {"tokens": batch["tokens"].to(device)}
            out = cell.fn(model, inputs)
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(5):
                out = cell.fn(model, inputs)
            _sync(device)
            print(f"{cell.kind} step: "
                  f"{1e3 * (time.perf_counter() - t0) / 5:.1f} ms {where}; "
                  f"logits {tuple(out.shape)}")


if __name__ == "__main__":
    main()
