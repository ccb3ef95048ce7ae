"""The port's attention (``repro_torch.kernels.ops.attention`` and the
plain versions in ``repro_torch.kernels.ref``) against the JAX
reference on the CPU: the Pallas kernel in interpret mode and the
reference's dense and chunked versions, on the same numpy inputs.

Also pins the rule that picks the wgmma kernel on the card
(``flash_attention.wgmma_eligible``) on CPU tensors, and that the CPU
path stays the plain version and launches nothing for operands the rule
admits.

Tolerances: float32 2e-5 and bfloat16 3e-2 max-abs on N(0, 1) inputs,
those of the reference's own ``test_flash_attention_sweep``
(``tests/test_kernels.py``): the sums run in another order, and a
bfloat16 output rounds once more.  The port's plain path against the
reference's plain path is held to 1e-5 in float32 (the same formula,
summed in another order) and to one bfloat16 step, 2^-6, in bfloat16
(an f32 result within 1e-5 of a rounding boundary may round the other
way).
"""

import numpy as np
import pytest

from _torch import torch

import jax.numpy as jnp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_plain, flash_attention_simple_cuda,
    flash_attention_wgmma_cuda, wgmma_eligible)

# the reference's sweep (tests/test_kernels.py::test_flash_attention_sweep)
SWEEP = [
    ((1, 2, 2, 128, 128, 64), True, "float32"),
    ((2, 4, 2, 256, 256, 64), True, "float32"),  # GQA group=2
    ((1, 8, 1, 100, 100, 32), False, "float32"),  # MQA, ragged seq
    ((1, 2, 1, 64, 192, 128), False, "bfloat16"),  # cross len + bf16
    ((1, 4, 4, 1, 300, 64), False, "float32"),  # decode shape
    ((1, 2, 2, 33, 65, 16), True, "float32"),  # non-aligned everything
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
PLAIN_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _inputs(shape, seed=0):
    b, hq, hkv, sq, sk, d = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
            rng.normal(size=(b, hkv, sk, d)).astype(np.float32))


def _jax(arrays, dt):
    return [jnp.asarray(a, getattr(jnp, dt)) for a in arrays]


def _torch(arrays, dt):
    return [torch.from_numpy(a).to(getattr(torch, dt)) for a in arrays]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape,causal,dt", SWEEP)
def test_attention_matches_pallas_and_reference(shape, causal, dt):
    arrays = _inputs(shape)
    jq, jk, jv = _jax(arrays, dt)
    pallas = flash_attention_pallas(jq, jk, jv, causal=causal, block_q=64,
                                    block_k=64, interpret=True)
    dense = jref.attention_ref(jq, jk, jv, causal=causal)
    before = dict(ops.LAUNCHES)
    got = ops.attention(*_torch(arrays, dt), causal=causal)
    assert ops.LAUNCHES == before  # the CPU path launches nothing
    assert got.dtype == getattr(torch, dt)
    assert tuple(got.shape) == tuple(pallas.shape)
    assert np.abs(_f32(got) - _f32(pallas)).max() < TOL[dt]
    assert np.abs(_f32(got) - _f32(dense)).max() <= PLAIN_TOL[dt]


@pytest.mark.parametrize("shape,causal,dt", [
    ((1, 7, 1, 40, 2100, 14), True, "float32"),  # qwen2 smoke D, group 7
    ((1, 4, 2, 3, 2048, 16), False, "bfloat16"),
    ((1, 2, 2, 2100, 2100, 16), True, "float32"),  # Sq > 1024: all blocks
])
def test_long_keys_take_the_chunked_path_as_the_reference(shape, causal, dt):
    """At Sk >= 2048 both packages' CPU paths are the chunked online
    softmax (``ops.attention`` of each); the port's equals the
    reference's, and both equal the dense formula."""
    arrays = _inputs(shape, seed=1)
    want = jops.attention(*_jax(arrays, dt), causal=causal)
    got = ops.attention(*_torch(arrays, dt), causal=causal)
    chunked = ref.attention_chunked(*_torch(arrays, dt), causal=causal)
    dense = ref.attention_ref(*_torch(arrays, dt), causal=causal)
    assert torch.equal(got, chunked)
    assert np.abs(_f32(got) - _f32(want)).max() <= PLAIN_TOL[dt]
    assert np.abs(_f32(got) - _f32(dense)).max() < TOL[dt]


@pytest.mark.parametrize("block_k", [32, 64, 1024])
def test_chunked_matches_reference_chunked_at_any_block(block_k):
    arrays = _inputs((1, 4, 2, 130, 130, 64), seed=2)
    want = jref.attention_chunked(*_jax(arrays, "float32"), causal=True,
                                  block_k=block_k)
    got = ref.attention_chunked(*_torch(arrays, "float32"), causal=True,
                                block_k=block_k)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)


def test_attention_takes_strided_views_and_a_scale():
    """A transposed (non-contiguous) q, as the layers hand it over, and an
    explicit scale, on the plain path."""
    q, k, v = _inputs((2, 6, 3, 20, 24, 16), seed=3)
    want = jref.attention_ref(*_jax((q, k, v), "float32"), causal=True,
                              scale=0.3)
    tq = torch.from_numpy(np.ascontiguousarray(q.transpose(0, 2, 1, 3))
                          ).transpose(1, 2)
    assert not tq.is_contiguous()
    got = flash_attention_plain(tq, *_torch((k, v), "float32"), causal=True,
                                scale=0.3)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)


def test_attention_on_other_devices_raises():
    q = torch.zeros((1, 1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.attention(q, q, q)


def test_kernel_wrapper_rejects_cpu_tensors():
    q = torch.zeros((1, 2, 4, 8))
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_cuda(q, q[:, :1], q[:, :1])
    assert ops.LAUNCHES["flash_attention"] == before


def _bshd(b, s, h, d, dtype=torch.bfloat16, pad=0):
    """The layers' operand: a transposed view ``[B, H, S, D]`` of a
    ``[B, S, H, D + pad]`` projection, its rows cut to ``d``."""
    x = torch.zeros((b, s, h, d + pad), dtype=dtype)
    return x[..., :d].transpose(1, 2)


def _shifted(shape, dtype=torch.bfloat16):
    """A contiguous tensor whose base lies one element past an aligned
    allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


# (what, q, k, v): the wgmma kernel's rule on CPU tensors
ELIGIBLE = [
    ("contiguous D 64", torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16),
     None, None),
    ("contiguous D 128", torch.zeros((2, 4, 9, 128), dtype=torch.bfloat16),
     None, None),
    ("contiguous D 256", torch.zeros((1, 2, 3, 256), dtype=torch.bfloat16),
     None, None),
    ("layers' view, qwen2-7b heads", _bshd(1, 40, 28, 128),
     _bshd(1, 40, 4, 128), _bshd(1, 40, 4, 128)),
    ("layers' view, gemma-7b heads", _bshd(2, 33, 16, 256), None, None),
    ("Sq = 1 view", _bshd(1, 1, 7, 128), _bshd(1, 300, 1, 128),
     _bshd(1, 300, 1, 128)),
    ("16-element cut view", _bshd(1, 5, 2, 64, pad=16), None, None),
]
INELIGIBLE = [
    ("float32", torch.zeros((1, 2, 8, 128)), None, None),
    ("float16", torch.zeros((1, 2, 8, 128), dtype=torch.float16), None,
     None),
    ("D 14", torch.zeros((1, 2, 8, 14), dtype=torch.bfloat16), None, None),
    ("D 16", torch.zeros((1, 2, 8, 16), dtype=torch.bfloat16), None, None),
    ("D 32", torch.zeros((1, 2, 8, 32), dtype=torch.bfloat16), None, None),
    ("D 96", torch.zeros((1, 2, 8, 96), dtype=torch.bfloat16), None, None),
    ("d + 3 cut view", _bshd(1, 5, 2, 128, pad=3), None, None),
    ("odd base offset", _shifted((1, 2, 8, 128)), None, None),
    ("odd base offset of v only", torch.zeros((1, 2, 8, 128),
                                               dtype=torch.bfloat16),
     None, _shifted((1, 2, 8, 128))),
    ("strided D", torch.zeros((1, 2, 8, 256),
                              dtype=torch.bfloat16)[..., ::2], None, None),
    ("float32 k", torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16),
     torch.zeros((1, 2, 8, 64)), None),
    ("3-d", torch.zeros((2, 8, 64), dtype=torch.bfloat16), None, None),
]


@pytest.mark.parametrize("what,q,k,v", ELIGIBLE, ids=[c[0] for c in ELIGIBLE])
def test_wgmma_rule_admits(what, q, k, v):
    k = q if k is None else k
    v = k if v is None else v
    assert wgmma_eligible(q, k, v)


@pytest.mark.parametrize("what,q,k,v", INELIGIBLE,
                         ids=[c[0] for c in INELIGIBLE])
def test_wgmma_rule_refuses(what, q, k, v):
    k = q if k is None else k
    v = k if v is None else v
    assert not wgmma_eligible(q, k, v)


def test_wgmma_rule_ignores_strides_of_extent_one():
    """A dimension of extent 1 is never stepped over, so its stride may be
    anything; one longer than 1 may not."""
    base = torch.zeros((4, 3, 128), dtype=torch.bfloat16)
    q = base.as_strided((1, 1, 3, 128), (5, 7, 128, 1))
    assert wgmma_eligible(q, q, q)
    q = base.as_strided((2, 1, 3, 128), (5, 7, 128, 1))
    assert not wgmma_eligible(q, q, q)
    q = base.as_strided((1, 2, 3, 128), (0, 0, 128, 1))
    assert not wgmma_eligible(q, q, q)  # a broadcast head: stride 0


@pytest.mark.parametrize("shape,causal", [
    ((1, 7, 1, 40, 40, 128), True),  # the layers' prefill at qwen2-7b's D
    ((1, 2, 2, 1, 70, 256), False),
])
def test_cpu_attention_on_eligible_operands_takes_the_plain_path(shape,
                                                                 causal):
    """Operands the wgmma rule admits, on the CPU: ``ops.attention`` is the
    plain version, bit for bit, and launches nothing."""
    b, hq, hkv, sq, sk, d = shape
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, d))
                                .astype(np.float32)).to(torch.bfloat16)
               .transpose(1, 2) for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
    assert wgmma_eligible(q, k, v)
    before = dict(ops.LAUNCHES)
    got = ops.attention(q, k, v, causal=causal)
    assert ops.LAUNCHES == before
    assert torch.equal(got, flash_attention_plain(q, k, v, causal=causal))


@pytest.mark.parametrize("entry", [flash_attention_cuda,
                                   flash_attention_simple_cuda,
                                   flash_attention_wgmma_cuda])
def test_kernel_entries_reject_eligible_cpu_tensors(entry):
    """bf16 operands the wgmma rule admits, but on the CPU: every entry
    raises before it launches either kernel."""
    q = torch.zeros((1, 2, 4, 128), dtype=torch.bfloat16)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="one CUDA device"):
        entry(q, q[:, :1], q[:, :1])
    assert ops.LAUNCHES == before
