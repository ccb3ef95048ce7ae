"""Dense decoder-only LM (GLM-4 / Gemma / Qwen2 family) as ``nn.Module``s.

- ``Transformer`` holds ``embed``, an ``nn.ModuleList`` of ``Block``s
  (``layers.{i}.attn_norm`` / ``.attn`` / ``.ffn_norm`` / ``.ffn``),
  ``final_norm`` and, unless embeddings are tied, ``unembed``: the names
  of the JAX reference's param tree, which ``load_reference_params``
  copies across;
- GQA attention through ``ops.attention`` (the flash-attention kernel on
  the card), RoPE (optionally partial, GLM-4 style), GLU FFN (SwiGLU /
  GeGLU), optional QKV bias (Qwen2 / GLM), optional tied embeddings and
  embedding scaling (Gemma);
- ``decode_step`` runs one token against a preallocated KV cache with
  the reference's grouped-einsum masked attention, which is plain torch
  (the reference's decode reaches no kernel either).

The reference scans a stacked layer axis; here the layers are a loop over
the module list, which computes the same.  Nothing here needs a gradient:
the parameters do not require one, and serving runs under
``torch.inference_mode()``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as L


@dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, field for field, so the registries read the
    same.  ``remat``, ``ce_chunks`` and ``scan_layers`` shape the
    reference's training step and its lowering; an inference forward
    computes the same with any of their values, and here they do nothing.
    """
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv: int = 2
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1000
    act: str = "swiglu"  # swiglu | geglu
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # Gemma: x *= sqrt(d_model)
    dtype: str = "bfloat16"
    remat: bool = True
    ce_chunks: int = 1
    scan_layers: bool = True

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def n_params(self) -> int:
        """Analytic parameter count (norm scales and biases aside)."""
        d, h, kv, hd, f, v = (self.d_model, self.n_heads, self.n_kv,
                              self.head_dim, self.d_ff, self.vocab)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        ffn = 3 * d * f
        per_layer = attn + ffn + 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


class Block(nn.Module):
    """One pre-norm layer: attention, then the GLU FFN, each residual."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator):
        super().__init__()
        dt = cfg.torch_dtype
        self.attn_norm = L.RMSNorm(cfg.d_model, gen.device)
        self.attn = L.Attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv,
                                cfg.head_dim, cfg.qkv_bias, dt)
        self.ffn_norm = L.RMSNorm(cfg.d_model, gen.device)
        self.ffn = L.GluFFN(gen, cfg.d_model, cfg.d_ff, dt, cfg.act)

    def forward(self, x: torch.Tensor, cfg: TransformerConfig,
                positions: torch.Tensor) -> torch.Tensor:
        h, _ = self.attn(self.attn_norm(x), cfg.n_heads, cfg.n_kv,
                         cfg.head_dim, positions, cfg.rope_theta,
                         cfg.rope_fraction, causal=True)
        x = x + h
        return x + self.ffn(self.ffn_norm(x))


def _device(device: str | torch.device) -> torch.device:
    """``device`` as a torch device; raises for CUDA where there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


class Transformer(nn.Module):
    """The dense LM.  Built on ``device`` (the card by default; raises where
    there is none) with weights drawn from ``generator``, a
    ``torch.Generator`` on that device."""

    def __init__(self, cfg: TransformerConfig,
                 device: str | torch.device = "cuda", *,
                 generator: torch.Generator):
        super().__init__()
        device = _device(device)
        if generator.device.type != device.type:
            raise ValueError(f"the generator is on {generator.device}, the "
                             f"model on {device}")
        self.cfg = cfg
        dt = cfg.torch_dtype
        emb = torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                          dtype=torch.float32, device=device) * 0.02
        self.embed = nn.Parameter(emb.to(dt), requires_grad=False)
        self.layers = nn.ModuleList(Block(cfg, generator)
                                    for _ in range(cfg.n_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.unembed = nn.Parameter(
                L._init_dense(generator, cfg.d_model, cfg.vocab, dt),
                requires_grad=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed[tokens.to(self.device)]
        if self.cfg.scale_embeddings:
            # the constant is rounded to the activation dtype first, as the
            # reference's jnp.asarray(d ** 0.5, x.dtype) is
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=x.dtype,
                                 device=x.device)
        return x

    def _w_out(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.unembed

    def forward_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens ``[B, S]`` -> final hidden states ``[B, S, d]``."""
        x = self._embed(tokens)
        positions = torch.arange(tokens.shape[1], device=self.device)
        for block in self.layers:
            x = block(x, self.cfg, positions)
        return self.final_norm(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens ``[B, S]`` -> logits ``[B, S, V]``."""
        x = self.forward_hidden(tokens)
        return torch.matmul(x, self._w_out().to(x.dtype))

    # --------------------------------------------------------------- decode

    def init_cache(self, batch: int, seq: int) -> dict:
        """KV cache ``[L, B, n_kv, S, head_dim]`` in the model's dtype,
        zeroed, on the model's device."""
        c = self.cfg
        shape = (c.n_layers, batch, c.n_kv, seq, c.head_dim)
        return {"k": torch.zeros(shape, dtype=c.torch_dtype,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=c.torch_dtype,
                                 device=self.device)}

    def decode_step(self, token: torch.Tensor, cache: dict, pos: int
                    ) -> tuple[torch.Tensor, dict]:
        """One-token decode against a filled cache.

        token ``[B]``; cache k/v ``[L, B, n_kv, S, D]`` (S = context
        length); pos: the current position.  Returns ``(logits [B, V],
        cache)``.  Attention over the cache masks keys past ``pos`` (the
        cache is preallocated at the full context).  The new token's K/V
        are written into ``cache`` in place, at ``pos`` clamped into
        ``[0, S - 1]`` as the reference's ``dynamic_update_slice`` clamps
        (the mask and RoPE take ``pos`` as it is); the in-place write
        keeps one copy of the cache on the card, where the reference
        returns a new one.
        """
        c = self.cfg
        b = token.shape[0]
        x = self._embed(token[:, None])  # [B, 1, d]
        positions = torch.full((1,), pos, dtype=torch.int32,
                               device=self.device)
        s_len = cache["k"].shape[3]
        at = min(max(int(pos), 0), s_len - 1)
        group = c.n_heads // c.n_kv
        mask = torch.arange(s_len, device=self.device) <= pos
        for i, block in enumerate(self.layers):
            p = L.param_set(block.attn)
            xn = block.attn_norm(x)
            q = L.dense(xn, p["wq"], p.get("bq")).reshape(
                b, 1, c.n_heads, c.head_dim).transpose(1, 2)
            kk = L.dense(xn, p["wk"], p.get("bk")).reshape(
                b, 1, c.n_kv, c.head_dim).transpose(1, 2)
            vv = L.dense(xn, p["wv"], p.get("bv")).reshape(
                b, 1, c.n_kv, c.head_dim).transpose(1, 2)
            q = L.apply_rope(q, positions, c.rope_theta, c.rope_fraction)
            kk = L.apply_rope(kk, positions, c.rope_theta, c.rope_fraction)
            ck, cv = cache["k"][i], cache["v"][i]
            ck[:, :, at] = kk[:, :, 0].to(ck.dtype)
            cv[:, :, at] = vv[:, :, 0].to(cv.dtype)
            # masked attention over the preallocated cache, grouped (no KV
            # repeat), in float32
            qg = q[:, :, 0].reshape(b, c.n_kv, group, c.head_dim)
            s = torch.einsum("bkgd,bksd->bkgs", qg.float(),
                             ck.float()) / (c.head_dim ** 0.5)
            s = torch.where(mask, s, -1e30)
            pr = torch.softmax(s, dim=-1)
            o = torch.einsum("bkgs,bksd->bkgd", pr,
                             cv.float()).to(x.dtype)
            o = o.reshape(b, 1, c.n_heads * c.head_dim)
            x = x + L.dense(o, p["wo"])
            x = x + block.ffn(block.ffn_norm(x))
        x = self.final_norm(x)
        logits = torch.matmul(x, self._w_out().to(x.dtype))[:, 0]
        return logits, cache


# ------------------------------------------------------- reference weights

def _as_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor; a bfloat16 array (numpy's extension
    type, which ``torch.from_numpy`` rejects) is reinterpreted bit for bit
    through uint16."""
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flatten(prefix: str, node, out: dict) -> None:
    """A nested dict's leaves under dotted names."""
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(f"{prefix}{k}.", v, out)
    else:
        out[prefix[:-1]] = node


def load_reference_params(model: Transformer, tree: dict) -> Transformer:
    """Copy the JAX reference's param tree into ``model``.

    ``tree`` is the reference's ``transformer.init`` output as numpy
    arrays (``jax.tree.map(np.asarray, params)``): ``embed``,
    ``layers`` (every leaf stacked on a leading layer axis, as the
    reference's ``vmap`` init stacks them), ``final_norm`` and
    ``unembed``.  Every parameter of ``model`` is written, with its
    shape and dtype checked, and none is left out."""
    flat: dict[str, np.ndarray] = {}
    _flatten("", {k: v for k, v in tree.items() if k != "layers"}, flat)
    per_layer: dict[str, np.ndarray] = {}
    _flatten("", tree["layers"], per_layer)
    for name, a in per_layer.items():
        for i in range(a.shape[0]):
            flat[f"layers.{i}.{name}"] = a[i]

    params = dict(model.named_parameters())
    if set(params) != set(flat):
        raise ValueError(f"param trees differ: only in the model "
                         f"{sorted(set(params) - set(flat))}, only in the "
                         f"reference's {sorted(set(flat) - set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            t = _as_tensor(flat[name])
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: reference {tuple(t.shape)} "
                                 f"{t.dtype}, model {tuple(p.shape)} "
                                 f"{p.dtype}")
            p.copy_(t)
    return model
