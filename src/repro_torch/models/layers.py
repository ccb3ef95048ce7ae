"""Shared neural layers: norms, RoPE, attention, the GLU FFN.

The functions are plain functions on tensors, as the JAX reference's
are (``repro/models/layers.py``): a parameter set is a mapping of names
to tensors (``"wq"``, ``"scale"``, ...), ``init_*`` builds one from an
explicit ``torch.Generator`` on an explicit device, and the apply
functions read it.  The modules (``RMSNorm``, ``Attention``, ``GluFFN``)
hold such a set as ``nn.Parameter``s under the same names and call the
functions with it.

Types are explicit everywhere: a weight is cast to the activation's
dtype before its product (``dense``), norms and RoPE compute in float32
and return the input's dtype, and norm scales are stored in float32
whatever the weights' dtype.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.kernels import ops as kops

Params = Mapping[str, torch.Tensor]


def _init_dense(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, scale: float | None = None
                ) -> torch.Tensor:
    """A ``[d_in, d_out]`` weight: normal in float32 times ``scale``
    (Glorot by default), then cast, on the generator's device."""
    if scale is None:
        scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * scale).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
          ) -> torch.Tensor:
    """``x @ w (+ b)`` with ``w`` and ``b`` cast to ``x``'s dtype first."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def param_set(module: nn.Module) -> dict[str, torch.Tensor]:
    """A module's own parameters by name: the set its layer function reads."""
    return dict(module.named_parameters(recurse=False))


# ------------------------------------------------------------------ RMSNorm

def init_rmsnorm(d: int, device: str | torch.device,
                 dtype: torch.dtype = torch.float32) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(x: torch.Tensor, p: Params, eps: float = 1e-6,
            plus_one: bool = True) -> torch.Tensor:
    """RMSNorm in float32; ``plus_one`` stores the scale as an offset from 1
    (zero-init is the identity)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    xn = xf * torch.rsqrt(var + eps)
    scale = p["scale"].float()
    scale = (1.0 + scale) if plus_one else scale
    return (xn * scale).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device: str | torch.device):
        super().__init__()
        for name, t in init_rmsnorm(d, device).items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, param_set(self))


# --------------------------------------------------------------------- RoPE

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device: str | torch.device = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0, fraction: float = 1.0
               ) -> torch.Tensor:
    """Rotary embedding over the leading ``fraction`` of the head dim, on
    interleaved (even, odd) pairs, computed in float32.

    x: ``[..., S, D]``; positions: ``[S]`` or broadcastable to x[..., S].
    """
    d = x.shape[-1]
    d_rot = int(d * fraction)
    d_rot -= d_rot % 2
    if d_rot == 0:
        return x
    xr, xp = x[..., :d_rot], x[..., d_rot:]
    freqs = rope_freqs(d_rot, theta, x.device)
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rot = torch.stack([r1, r2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([rot, xp], dim=-1)


# ---------------------------------------------------------------- attention

def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, qkv_bias: bool,
                   dtype: torch.dtype) -> dict:
    p = {
        "wq": _init_dense(gen, d_model, n_heads * head_dim, dtype),
        "wk": _init_dense(gen, d_model, n_kv * head_dim, dtype),
        "wv": _init_dense(gen, d_model, n_kv * head_dim, dtype),
        "wo": _init_dense(gen, n_heads * head_dim, d_model, dtype),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((width * head_dim,), dtype=dtype,
                                  device=gen.device)
    return p


def attention(x: torch.Tensor, p: Params, n_heads: int, n_kv: int,
              head_dim: int, positions: torch.Tensor, rope_theta: float,
              rope_fraction: float = 1.0, causal: bool = True,
              kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
              ) -> tuple[torch.Tensor,
                         tuple[torch.Tensor, torch.Tensor] | None]:
    """GQA attention; optionally reads and extends a KV cache.

    x ``[B, S, d_model]`` -> ``[B, S, d_model]``.  With ``kv_cache`` =
    (k, v) of shape ``[B, n_kv, S_past, head_dim]`` the new keys and
    values are appended, the new rows attend to every key (no causal
    mask), and the extended cache is returned.  q, k and v reach
    ``ops.attention`` as transposed views ``[B, H, S, D]``.
    """
    b, s, _ = x.shape
    q = dense(x, p["wq"], p.get("bq")).reshape(b, s, n_heads, head_dim)
    k = dense(x, p["wk"], p.get("bk")).reshape(b, s, n_kv, head_dim)
    v = dense(x, p["wv"], p.get("bv")).reshape(b, s, n_kv, head_dim)
    q = q.transpose(1, 2)  # [B, H, S, D]
    k = k.transpose(1, 2)
    v = v.transpose(1, 2)
    q = apply_rope(q, positions, rope_theta, rope_fraction)
    k = apply_rope(k, positions, rope_theta, rope_fraction)

    new_cache = None
    if kv_cache is not None:
        pk, pv = kv_cache
        k = torch.cat([pk.to(k.dtype), k], dim=2)
        v = torch.cat([pv.to(v.dtype), v], dim=2)
        new_cache = (k, v)
        causal = False  # the new rows attend to everything

    o = kops.attention(q, k, v, causal=causal)
    o = o.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    return dense(o, p["wo"]), new_cache


class Attention(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, n_heads: int,
                 n_kv: int, head_dim: int, qkv_bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        for name, t in init_attention(gen, d_model, n_heads, n_kv, head_dim,
                                      qkv_bias, dtype).items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def forward(self, x, n_heads, n_kv, head_dim, positions, rope_theta,
                rope_fraction=1.0, causal=True, kv_cache=None):
        return attention(x, param_set(self), n_heads, n_kv, head_dim,
                         positions, rope_theta, rope_fraction, causal,
                         kv_cache)


# ---------------------------------------------------------------------- FFN

def init_glu_ffn(gen: torch.Generator, d_model: int, d_ff: int,
                 dtype: torch.dtype) -> dict:
    return {
        "wi": _init_dense(gen, d_model, d_ff, dtype),
        "wg": _init_dense(gen, d_model, d_ff, dtype),
        "wo": _init_dense(gen, d_ff, d_model, dtype),
    }


def glu_ffn(x: torch.Tensor, p: Params, act: str = "swiglu"
            ) -> torch.Tensor:
    """GLU FFN: ``silu(x wg) * (x wi)`` (swiglu) or the tanh-approximated
    ``gelu(x wg) * (x wi)`` (geglu), then ``wo``."""
    h = dense(x, p["wi"])
    g = dense(x, p["wg"])
    if act == "swiglu":
        h = F.silu(g) * h
    elif act == "geglu":
        h = F.gelu(g, approximate="tanh") * h
    else:
        raise ValueError(act)
    return dense(h, p["wo"])


class GluFFN(nn.Module):
    def __init__(self, gen: torch.Generator, d_model: int, d_ff: int,
                 dtype: torch.dtype, act: str):
        super().__init__()
        self.act = act
        for name, t in init_glu_ffn(gen, d_model, d_ff, dtype).items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return glu_ffn(x, param_set(self), self.act)
