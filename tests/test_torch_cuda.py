"""The CUDA kernels, the engine (over a static store and a live one), the
scheduler and the LM forward on the card, held against the port's own
plain CPU path (exact, except attention's floats: see its tests).  Every test here needs an NVIDIA GPU: it
carries the ``cuda`` marker and skips where there is none.

This file imports only torch, numpy and ``repro_torch``, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

from _torch import cuda_device, torch  # noqa: F401  (cuda_device: fixture)

from repro_torch.core import INTERFACES, EngineConfig, QueryEngine, \
    QueryScheduler, SchedulerConfig, interleave_clients, results_as_numpy
from repro_torch.core.fragcache import FragmentEntry, replay
from repro_torch.kernels import ops, ref
from repro_torch.kernels.delta_probe import delta_probe_cuda, delta_probe_plain
from repro_torch.kernels.fingerprint import (fingerprint_rows_cuda,
                                             fingerprint_rows_plain)
from repro_torch.kernels.flash_attention import (
    flash_attention_cuda, flash_attention_plain, flash_attention_simple_cuda,
    flash_attention_wgmma_cuda, wgmma_eligible)
from repro_torch.kernels.owned_probe import (eqrange_owned_cuda,
                                             eqrange_owned_plain)
from repro_torch.kernels.replay import replay_delta_cuda, replay_delta_plain
from repro_torch.kernels.run_probe import run_probe_cuda, run_probe_plain
from repro_torch.kernels.sorted_probe import (sorted_probe_cuda,
                                              sorted_probe_plain)
from repro_torch.configs import registry as lm_registry
from repro_torch.core.distributed import DistConfig, DistributedEngine
from repro_torch.models.transformer import Transformer
from repro_torch.rdf import (QueryLoadConfig, TripleStore, WatDivConfig,
                             generate_query_load, generate_watdiv)
from repro_torch.rdf.queries import QUERY_LOADS
from repro_torch.rdf.writes import WriteFeed

pytestmark = pytest.mark.cuda


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _np(t):
    return t.cpu().numpy()


@pytest.mark.parametrize("n,q", [
    (1000, 77), (4096, 512), (131, 512), (1, 1), (0, 5), (100_000, 4096),
])
def test_sorted_probe_kernel_matches_plain(cuda_device, n, q):
    rng = np.random.default_rng(n + q)
    keys = np.sort(rng.integers(-3, max(n * 3, 10), n)).astype(np.int64)
    queries = rng.integers(-5, max(n * 3, 10) + 5, q).astype(np.int64)
    if q >= 4:
        queries[:2] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min]
    before = ops.LAUNCHES["sorted_probe"]
    got = sorted_probe_cuda(_t(keys, cuda_device), _t(queries, cuda_device))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sorted_probe"] == before + 1
    want = sorted_probe_plain(_t(keys), _t(queries))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_cuda
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("n,r,vdt", [
    (1000, 77, np.int32), (4096, 512, np.int64), (131, 512, np.int32),
    (1, 1, np.int64), (100_000, 4096, np.int32),
])
def test_run_probe_kernel_matches_plain(cuda_device, n, r, vdt):
    rng = np.random.default_rng(n * 3 + r)
    vals = np.sort(rng.integers(0, max(n * 3, 10), n)).astype(vdt)
    lo = rng.integers(0, n + 1, r).astype(np.int32)
    hi = np.minimum(n, lo + rng.integers(0, n + 1, r)).astype(np.int32)
    targets = rng.integers(-5, max(n * 3, 10) + 5, r).astype(np.int64)
    targets[0] = np.iinfo(np.int64).max
    before = ops.LAUNCHES["run_probe"]
    got = run_probe_cuda(*(_t(a, cuda_device)
                           for a in (vals, lo, hi, targets)))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["run_probe"] == before + 1
    want = run_probe_plain(*(_t(a) for a in (vals, lo, hi, targets)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("n,q", [(1000, 77), (1, 5), (0, 9), (150_000, 4096)])
def test_sorted_probe_int32_kernel_matches_plain(cuda_device, n, q):
    """The int32 x int32 instantiation on tombstone-like columns."""
    rng = np.random.default_rng(n + 5 * q)
    n_base = 3 * n + 10
    keys = np.sort(rng.choice(n_base, n, replace=False)).astype(np.int32)
    queries = rng.integers(0, n_base + 1, q).astype(np.int32)
    queries[:2] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    got = sorted_probe_cuda(_t(keys, cuda_device), _t(queries, cuda_device))
    torch.cuda.synchronize()
    want = sorted_probe_plain(_t(keys), _t(queries))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_cuda
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("m,t,q", [
    (64, 32, 128), (1000, 700, 513), (0, 40, 100), (50, 0, 100), (0, 0, 17),
    (30, 20, 0), (150_000, 150_000, 1 << 16),
])
def test_delta_probe_kernel_matches_plain(cuda_device, m, t, q):
    rng = np.random.default_rng(m + 3 * t + q)
    n_base = max(2 * t, 10)
    ins = np.sort(rng.integers(-(1 << 40), 1 << 40, m)).astype(np.int64)
    tomb = np.sort(rng.choice(n_base, t, replace=False)).astype(np.int32)
    qk = rng.integers(-(1 << 40), 1 << 40, q).astype(np.int64)
    if m and q:
        qk[:q // 2] = ins[rng.integers(0, m, q // 2)]
    lo = rng.integers(0, n_base + 1, q).astype(np.int32)
    hi = np.minimum(n_base, lo + rng.integers(0, n_base, q)).astype(np.int32)
    if q >= 3:
        qk[:3] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min, 0]
        lo[:3] = hi[:3] = [n_base, 0, 5]
    args = (ins, tomb, qk, lo, hi)
    before = ops.LAUNCHES["delta_probe"]
    got = delta_probe_cuda(*(_t(a, cuda_device) for a in args))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["delta_probe"] == before + (1 if q else 0)
    want = delta_probe_plain(*(_t(a) for a in args))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.is_cuda
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("lanes,n,cols", [
    (8, 1 << 16, 3), (1, 1000, 1), (3, 777, 0), (2, 0, 3), (4, 1, 6),
    (5, 300, 2),
])
def test_fingerprint_kernel_matches_plain(cuda_device, lanes, n, cols):
    rng = np.random.default_rng(lanes * 7 + n + cols)
    i32 = np.iinfo(np.int32)
    block = rng.integers(i32.min, i32.max, (lanes, n, cols), dtype=np.int64,
                         endpoint=True).astype(np.int32)
    if n >= 3 and cols:
        block[0, :3, 0] = [-1, i32.min, i32.max]
    valid = np.zeros((lanes, n), bool)
    lens = rng.integers(0, n + 1, lanes)
    for j, m in enumerate(lens):
        valid[j, :m] = True
    if lanes > 2:
        valid[-1] = rng.random(n) < 0.5  # a mask that is not a prefix
    before = ops.LAUNCHES["fingerprint_rows"]
    got = fingerprint_rows_cuda(_t(block, cuda_device),
                                _t(valid, cuda_device))
    torch.cuda.synchronize()
    assert ops.LAUNCHES["fingerprint_rows"] == before + 1
    want = fingerprint_rows_plain(_t(block), _t(valid))
    assert got.dtype == torch.int64 and got.shape == (lanes, 4)
    np.testing.assert_array_equal(_np(got), _np(want))
    for j in range(lanes - 1 if lanes > 2 else lanes):
        assert tuple(_np(got[j]).tolist()) == \
            ref.fingerprint_prefix_np(block[j, :lens[j]])


@pytest.mark.parametrize("lanes,cap,n_vars,n_w,m", [
    (8, 1 << 14, 6, 2, 1 << 14), (2, 64, 1, 1, 8), (3, 100, 4, 0, 40),
    (1, 16, 3, 3, 16), (4, 0, 2, 1, 0), (2, 50, 5, 2, 1),
])
def test_replay_kernel_matches_plain(cuda_device, lanes, cap, n_vars, n_w,
                                     m):
    rng = np.random.default_rng(lanes + cap + n_vars * 3 + m)
    seed = rng.integers(-1, 1 << 30, (lanes, cap, n_vars)).astype(np.int32)
    src = rng.integers(0, max(cap, 1), (lanes, m)).astype(np.int32)
    if m >= 2:
        src[0, :2] = [cap, cap + 9]  # past the table: clamped
    written = rng.integers(0, 1 << 30, (lanes, m, n_w)).astype(np.int32)
    n_out = rng.integers(0, m + 1, lanes).astype(np.int32)
    n_out[0] = 0
    if lanes > 1:
        n_out[1] = m + 3  # valid past M: UNBOUND rows
    cols = tuple(rng.permutation(n_vars)[:n_w].tolist())
    args = (seed, src, written, n_out)
    before = ops.LAUNCHES["replay_delta"]
    got = replay_delta_cuda(*(_t(a, cuda_device) for a in args), cols)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["replay_delta"] == before + (1 if cap else 0)
    want = replay_delta_plain(*(_t(a) for a in args), cols)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_cuda
        np.testing.assert_array_equal(_np(g), _np(w))
    if cap and m:
        j = lanes - 1
        k = int(min(n_out[j], m))
        rows, valid = replay(FragmentEntry(src[j, :k], written[j, :k],
                                           False, 0), seed[j], cap, n_vars,
                             cols)
        np.testing.assert_array_equal(_np(got[0][j])[valid], rows[valid])


I64 = np.iinfo(np.int64)
OWNED_EXTREMES = np.array([0, 1, -1, 2**31, 2**32 - 1, -(2**31), I64.min,
                           I64.min + 1, I64.max - 1, I64.max], np.int64)


@pytest.mark.parametrize("n,q,n_shards,my_shard", [
    (1000, 77, 4, 1), (4096, 513, 1, 0), (100_000, 4096, 4, 3),
    (1, 5, 3, 2), (0, 9, 2, 0), (3000, 0, 4, 0), (5000, 1000, 4097, 11),
    (5000, 1000, 10007, 4), (262_144, 1 << 16, 7, 6),
])
def test_eqrange_owned_kernel_matches_plain(cuda_device, n, q, n_shards,
                                            my_shard):
    """Bit-equal to the plain version: queries at the int64 extremes,
    negative and extreme subjects, every row owned at one shard, shard
    counts past the reference's 4096, an empty column and batch, and
    query counts that fill no block."""
    rng = np.random.default_rng(n + q + n_shards)
    keys = np.sort(rng.integers(-3, max(n * 3, 10), n)).astype(np.int64)
    queries = rng.integers(-5, max(n * 3, 10) + 5, q).astype(np.int64)
    subjects = rng.integers(I64.min, I64.max, q, dtype=np.int64)
    if q >= len(OWNED_EXTREMES):
        queries[:3] = [I64.max, I64.min, -1]
        subjects[:len(OWNED_EXTREMES)] = OWNED_EXTREMES
    before = ops.LAUNCHES["eqrange_owned"]
    got = eqrange_owned_cuda(*(_t(a, cuda_device)
                               for a in (keys, queries, subjects)),
                             my_shard, n_shards)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["eqrange_owned"] == before + (q > 0)
    want = eqrange_owned_plain(_t(keys), _t(queries), _t(subjects), my_shard,
                               n_shards)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.is_cuda
        np.testing.assert_array_equal(_np(g), _np(w))
    if n_shards == 1 and q:
        assert _np(got[2]).all()


def test_eqrange_owned_wrapper_validates_inputs(cuda_device):
    k = torch.arange(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int64"):
        eqrange_owned_cuda(k, k.to(torch.int32), k, 0, 2)
    with pytest.raises(ValueError, match="subjects must be int64"):
        eqrange_owned_cuda(k, k, k.to(torch.int32), 0, 2)
    with pytest.raises(ValueError, match="contiguous"):
        eqrange_owned_cuda(k, k[::2], k[::2].contiguous(), 0, 2)
    with pytest.raises(ValueError, match="subjects has 4 entries"):
        eqrange_owned_cuda(k, k, k[:4], 0, 2)
    with pytest.raises(ValueError, match="n_shards"):
        eqrange_owned_cuda(k, k, k, 0, 0)
    with pytest.raises(ValueError, match="CUDA device"):
        eqrange_owned_cuda(k, k, k.cpu(), 0, 2)


def test_kernel_wrappers_validate_inputs(cuda_device):
    k = torch.arange(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        sorted_probe_cuda(k, k[::2])
    with pytest.raises(ValueError, match="int64"):
        sorted_probe_cuda(k, k.to(torch.float32))
    with pytest.raises(ValueError, match="int64"):
        sorted_probe_cuda(k.to(torch.int32), k)
    with pytest.raises(ValueError, match="int64"):
        sorted_probe_cuda(k, k.to(torch.int32))
    with pytest.raises(ValueError, match="int32 x int32"):
        sorted_probe_cuda(k.to(torch.int16), k.to(torch.int16))
    b = k.to(torch.int32)
    with pytest.raises(ValueError, match="tomb_pos must be torch.int32"):
        delta_probe_cuda(k, k, k, b, b)
    with pytest.raises(ValueError, match="query_keys must be torch.int64"):
        delta_probe_cuda(k, b, b, b, b)
    with pytest.raises(ValueError, match="base_hi has 4 entries"):
        delta_probe_cuda(k, b, k, b, b[:4])
    with pytest.raises(ValueError, match="contiguous"):
        delta_probe_cuda(k[::2], b, k, b, b)
    with pytest.raises(ValueError, match="CUDA device"):
        sorted_probe_cuda(k, k.cpu())
    lo = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int32 run bounds"):
        run_probe_cuda(k, lo, lo, k)
    lo = lo.to(torch.int32)
    with pytest.raises(ValueError, match="targets must be int64"):
        run_probe_cuda(k, lo, lo, k.to(torch.int32))
    with pytest.raises(ValueError, match="values must be int32 or int64"):
        run_probe_cuda(k.to(torch.int16), lo, lo, k)
    block = torch.zeros((2, 8, 3), dtype=torch.int32, device=cuda_device)
    mask = torch.ones((2, 8), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="block must be torch.int32"):
        fingerprint_rows_cuda(block.to(torch.int64), mask)
    with pytest.raises(ValueError, match="valid must be torch.bool"):
        fingerprint_rows_cuda(block, mask.to(torch.int32))
    with pytest.raises(ValueError, match="contiguous"):
        fingerprint_rows_cuda(block[:, :, ::2], mask)
    with pytest.raises(ValueError, match=r"\[B, n, C\]"):
        fingerprint_rows_cuda(block[0], mask[0])
    with pytest.raises(ValueError, match="one CUDA device"):
        fingerprint_rows_cuda(block, mask.cpu())
    src = torch.zeros((2, 4), dtype=torch.int32, device=cuda_device)
    wr = torch.zeros((2, 4, 1), dtype=torch.int32, device=cuda_device)
    n_out = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="src must be torch.int32"):
        replay_delta_cuda(block, src.to(torch.int64), wr, n_out, (0,))
    with pytest.raises(ValueError, match="n_out must be torch.int32"):
        replay_delta_cuda(block, src, wr, n_out.to(torch.int64), (0,))
    with pytest.raises(ValueError, match="distinct columns"):
        replay_delta_cuda(block, src, wr, n_out, (3,))
    with pytest.raises(ValueError, match="seed_rows must be a contiguous 3-D"):
        replay_delta_cuda(block[0], src[0], wr[0], n_out[0], (0,))
    with pytest.raises(ValueError, match="M <= cap"):
        replay_delta_cuda(block[:, :2].contiguous(), src, wr, n_out, (0,))


# (B, Hq, Hkv, Sq, Sk, D), causal: the reference's sweep
# (tests/test_kernels.py), then D 14 / 16 / 128 / 256 at GQA groups 1 and 7,
# then rows long enough that |o| falls to a few hundredths (32 KV tiles)
ATTN_SHAPES = [
    ((1, 2, 2, 128, 128, 64), True), ((2, 4, 2, 256, 256, 64), True),
    ((1, 8, 1, 100, 100, 32), False), ((1, 2, 1, 64, 192, 128), False),
    ((1, 4, 4, 1, 300, 64), False), ((1, 2, 2, 33, 65, 16), True),
    ((2, 7, 1, 70, 130, 14), True), ((1, 14, 2, 65, 200, 16), True),
    ((1, 7, 7, 129, 129, 128), True), ((1, 14, 2, 96, 33, 128), True),
    ((1, 4, 4, 100, 257, 256), False), ((1, 7, 1, 1, 513, 256), False),
    ((1, 7, 1, 2048, 2048, 128), True), ((1, 2, 2, 300, 2100, 256), False),
]
# max-abs on N(0, 1) inputs: the reference sweep's tolerances; bfloat16 is
# also held elementwise to two bf16 steps of the plain value plus 1e-5, a
# bound that scales with |o| where 3e-2 would not (both round one f32 sum)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
BF16_STEPS, BF16_ABS = 2 ** -6, 1e-5


def _hold_attention(got, q, k, v, causal, dtype, scale=None):
    """``got`` against the plain version on the CPU, with the stated
    tolerances."""
    # the plain version runs twice and the second call is compared: the
    # first float32 CPU einsum in a process has been seen off by up to
    # 9e-5 on the card's host, once in several runs
    plain = (q.cpu(), k.cpu(), v.cpu())
    flash_attention_plain(*plain, causal=causal, scale=scale)
    want = flash_attention_plain(*plain, causal=causal, scale=scale)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    assert got.is_contiguous()
    diff = (got.cpu().float() - want.float()).abs()
    assert float(diff.max()) < ATTN_TOL[dtype]
    if dtype == torch.bfloat16:
        assert bool((diff <= BF16_STEPS * want.float().abs() + BF16_ABS)
                    .all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,causal", ATTN_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda_device, shape, causal,
                                              dtype):
    """The simple kernel against its plain version, q a strided view: the
    transpose of ``[B, S, H, D]`` the layers hand over, its rows cut from
    wider ones (so it is not contiguous at Sq = 1 either).  The cut (d + 3
    columns) breaks the wgmma kernel's rule, so the dispatcher takes the
    simple kernel in both dtypes."""
    b, hq, hkv, sq, sk, d = shape
    rng = np.random.default_rng(sum(shape))
    q = _t(rng.normal(size=(b, sq, hq, d + 3)).astype(np.float32),
           cuda_device).to(dtype)[..., :d].transpose(1, 2)
    k, v = (_t(rng.normal(size=(b, hkv, sk, d)).astype(np.float32),
               cuda_device).to(dtype) for _ in range(2))
    assert not q.is_contiguous() and not wgmma_eligible(q, k, v)
    before = dict(ops.LAUNCHES)
    got = flash_attention_cuda(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert (ops.LAUNCHES["flash_attention_wgmma"]
            == before["flash_attention_wgmma"])
    _hold_attention(got, q, k, v, causal, dtype)


# (B, Hq, Hkv, Sq, Sk, D), causal, q as a view of [B, S, H, D], the softmax
# scale (None: D^-1/2): shapes the wgmma kernel's rule admits — D 64 / 128 /
# 256, GQA groups 1 and 7, Sq = 1, ragged Sq and Sk around the 128-row query
# and 64-key tiles, causal with Sq != Sk, the 2048 x 2048 long rows, and one
# scale given by the caller
WGMMA_SHAPES = [
    ((1, 2, 2, 128, 128, 64), True, False, None),
    ((2, 4, 2, 256, 256, 64), True, True, None),
    ((1, 4, 4, 1, 300, 64), False, True, None),
    ((1, 2, 1, 64, 192, 128), False, False, None),
    ((1, 7, 7, 129, 129, 128), True, True, None),
    ((1, 14, 2, 33, 65, 128), True, True, None),
    ((1, 14, 2, 300, 257, 128), True, False, None),
    ((1, 7, 1, 65, 200, 128), True, True, None),  # causal, Sq < Sk
    ((1, 7, 1, 257, 129, 128), True, True, None),  # causal, Sq > Sk
    ((1, 7, 1, 1, 513, 128), True, True, None),  # Sq = 1, causal: key 0 only
    ((1, 4, 4, 100, 257, 256), False, True, None),
    ((1, 7, 1, 1, 513, 256), False, True, None),
    ((1, 2, 2, 300, 300, 256), True, False, None),
    ((1, 7, 1, 2048, 2048, 128), True, True, None),
    ((1, 2, 2, 2048, 2048, 256), True, True, None),
    ((1, 4, 4, 70, 70, 64), True, False, 0.3),  # a scale other than D^-1/2
]


@pytest.mark.parametrize("shape,causal,bshd,scale", WGMMA_SHAPES)
def test_flash_attention_wgmma_kernel_matches_plain(cuda_device, shape,
                                                    causal, bshd, scale):
    """The wgmma kernel, reached through the dispatcher, against the plain
    version: one launch of it and none of the simple kernel."""
    b, hq, hkv, sq, sk, d = shape
    rng = np.random.default_rng(sum(shape) + 1)

    def operand(h, s):
        x = rng.normal(size=(b, s, h, d) if bshd else (b, h, s, d))
        x = _t(x.astype(np.float32), cuda_device).to(torch.bfloat16)
        return x.transpose(1, 2) if bshd else x

    q, k, v = operand(hq, sq), operand(hkv, sk), operand(hkv, sk)
    assert wgmma_eligible(q, k, v)
    before = dict(ops.LAUNCHES)
    got = flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES["flash_attention_wgmma"]
            == before["flash_attention_wgmma"] + 1)
    assert ops.LAUNCHES["flash_attention"] == before["flash_attention"]
    _hold_attention(got, q, k, v, causal, torch.bfloat16, scale)


def test_flash_attention_wgmma_wrapper_validates_inputs(cuda_device):
    q = torch.zeros((1, 4, 8, 128), dtype=torch.bfloat16, device=cuda_device)
    kv = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16,
                     device=cuda_device)
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match="must all be torch.bfloat16"):
        flash_attention_wgmma_cuda(q.float(), kv.float(), kv.float())
    with pytest.raises(ValueError, match="must all be torch.bfloat16"):
        flash_attention_wgmma_cuda(q, kv.half(), kv)
    with pytest.raises(ValueError, match="the wgmma kernel takes"):
        flash_attention_wgmma_cuda(q[..., :32], kv[..., :32], kv[..., :32])
    wide = torch.zeros((1, 8, 4, 131), dtype=torch.bfloat16,
                       device=cuda_device)[..., :128].transpose(1, 2)
    with pytest.raises(ValueError, match="the wgmma kernel takes"):
        flash_attention_wgmma_cuda(wide, kv, kv)
    flat = torch.zeros(4 * 8 * 128 + 1, dtype=torch.bfloat16,
                       device=cuda_device)
    with pytest.raises(ValueError, match="the wgmma kernel takes"):
        flash_attention_wgmma_cuda(flat[1:].view(1, 4, 8, 128), kv, kv)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_wgmma_cuda(q, kv[:, :1].expand(1, 3, 8, 128),
                                   kv[:, :1].expand(1, 3, 8, 128))
    with pytest.raises(ValueError, match="at least one key"):
        flash_attention_wgmma_cuda(q, kv[:, :, :0], kv[:, :, :0])
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_wgmma_cuda(q, kv.cpu(), kv)
    assert ops.LAUNCHES == before
    empty = flash_attention_wgmma_cuda(q[:, :, :0], kv, kv)
    assert empty.shape == (1, 4, 0, 128) and ops.LAUNCHES == before


def test_flash_attention_wrapper_validates_inputs(cuda_device):
    q = torch.zeros((1, 4, 8, 16), device=cuda_device)
    kv = torch.zeros((1, 2, 8, 16), device=cuda_device)
    before = ops.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="float32 or all"):
        flash_attention_cuda(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="float32 or all"):
        flash_attention_cuda(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_cuda(q, kv[:, :1].expand(1, 3, 8, 16),
                             kv[:, :1].expand(1, 3, 8, 16))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q, kv[..., :8], kv[..., :8])
    with pytest.raises(ValueError, match="head dim must be in"):
        wide = torch.zeros((1, 2, 8, 264), device=cuda_device)
        flash_attention_cuda(wide, wide, wide)
    with pytest.raises(ValueError, match="at least one key"):
        flash_attention_cuda(q, kv[:, :, :0], kv[:, :, :0])
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_cuda(q, kv.cpu(), kv)
    with pytest.raises(ValueError, match="float32 or all"):
        flash_attention_simple_cuda(q.half(), kv.half(), kv.half())
    assert ops.LAUNCHES["flash_attention"] == before


@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma-7b"])
def test_lm_forward_on_card_matches_cpu(cuda_device, arch):
    """A smoke-size forward in float32 on the card (the kernel) against the
    same weights on the CPU (plain attention), within 1e-4 (the sums run
    in another order)."""
    from dataclasses import replace

    cfg = replace(lm_registry.get(arch).smoke, dtype="float32")
    model = Transformer(cfg, device="cpu",
                        generator=torch.Generator("cpu").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 40)).astype(np.int32))
    with torch.inference_mode():
        want = model(tokens)
        model.to(cuda_device)
        before = ops.LAUNCHES["flash_attention"]
        got = model(tokens.to(cuda_device))
        torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + cfg.n_layers
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert torch.equal(got.cpu().argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def small_world():
    g = generate_watdiv(WatDivConfig(scale=10))
    store = TripleStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                              n_predicates=g.n_predicates)
    loads = {load: generate_query_load(g, store, load,
                                       QueryLoadConfig(n_queries=2))
             for load in QUERY_LOADS}
    return store, loads


@pytest.mark.parametrize("interface", INTERFACES)
@pytest.mark.parametrize("planner", [True, False])
def test_engine_on_card_matches_cpu(cuda_device, small_world, interface,
                                    planner):
    store, loads = small_world
    cfg = EngineConfig(interface=interface, cap=256, capacity_planner=planner)
    card = QueryEngine(store, cfg)
    host = QueryEngine(store, cfg, device="cpu")
    assert card.device.type == "cuda"
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    for load, qs in loads.items():
        for q in qs:
            t_card, s_card = card.run(q)
            t_host, s_host = host.run(q)
            a, b = results_as_numpy(t_card), results_as_numpy(t_host)
            assert a.dtype == b.dtype and np.array_equal(a, b), load
            assert tuple(int(x) for x in s_card)[:6] == \
                tuple(int(x) for x in s_host)[:6], load
    assert ops.LAUNCHES["sorted_probe"] > 0
    assert ops.LAUNCHES["run_probe"] > 0


def test_live_engine_on_card_matches_cpu(cuda_device):
    """A scale-10 store under three seeded write windows: every load's
    queries on the card through the merged path equal the CPU run."""
    g = generate_watdiv(WatDivConfig(scale=10))
    store = TripleStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                              n_predicates=g.n_predicates)
    loads = {load: generate_query_load(g, store, load,
                                       QueryLoadConfig(n_queries=2))
             for load in QUERY_LOADS}
    read = {t.p.id for qs in loads.values() for q in qs for t in q.patterns
            if not t.p.is_var}
    feed = WriteFeed(store, read, rate=0.03, seed=1)
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    for _ in range(3):
        store.apply_delta(**feed.next_window())
        for interface in INTERFACES:
            cfg = EngineConfig(interface=interface, cap=256)
            card = QueryEngine(store, cfg)
            host = QueryEngine(store, cfg, device="cpu")
            for load, qs in loads.items():
                for q in qs:
                    t_card, s_card = card.run(q)
                    t_host, s_host = host.run(q)
                    assert np.array_equal(results_as_numpy(t_card),
                                          results_as_numpy(t_host)), load
                    assert tuple(int(x) for x in s_card)[:6] == \
                        tuple(int(x) for x in s_host)[:6], load
    assert min(ops.LAUNCHES[k] for k in ("sorted_probe", "run_probe",
                                         "delta_probe")) > 0


class _WaveLog(QueryScheduler):
    """Records each wave's job count and its fingerprint and replay
    launches."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.waves_log = []

    def _run_wave(self, jobs, results):
        fp, rp = ops.LAUNCHES["fingerprint_rows"], ops.LAUNCHES["replay_delta"]
        out = super()._run_wave(jobs, results)
        self.waves_log.append((len(jobs),
                               ops.LAUNCHES["fingerprint_rows"] - fp,
                               ops.LAUNCHES["replay_delta"] - rp))
        return out


def test_scheduler_on_card_matches_cpu(cuda_device, small_world):
    """A 4-client stream through the scheduler on the card, drained cold
    and warm, with request collapsing on and off: every response equals
    the CPU scheduler's (rows and all ten stats fields), the warm drain
    replays waves on the card, and with collapsing off the digest and
    the replay run on waves four lanes wide."""
    store, loads = small_world
    qs = [q for load in ("1-star", "2-stars", "paths") for q in loads[load]]
    stream = interleave_clients(qs, 4)
    cfg = EngineConfig(interface="spf", cap=256)
    for collapse in (True, False):
        scfg = SchedulerConfig(lanes=4, collapse_duplicates=collapse)
        card = _WaveLog(store, cfg, scfg)
        host = QueryScheduler(store, cfg, scfg, device="cpu")
        assert card.device.type == "cuda"
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        for drain in ("cold", "warm"):
            skipped = card.metrics.steps_skipped
            replays = ops.LAUNCHES["replay_delta"]
            got, want = card.serve(stream), host.serve(stream)
            for (gt, gs), (wt, ws) in zip(got, want):
                assert np.array_equal(results_as_numpy(gt),
                                      results_as_numpy(wt))
                assert tuple(int(x) for x in gs) == tuple(int(x) for x in ws)
            assert card.metrics.as_dict() == host.metrics.as_dict(), drain
            assert list(card.cache._entries) == list(host.cache._entries)
        assert card.metrics.steps_skipped > skipped
        assert ops.LAUNCHES["replay_delta"] > replays
        assert ops.LAUNCHES["fingerprint_rows"] > 0
        if not collapse:
            assert card.cache.stats.shared_hits > 0
            assert any(n == 4 and fp for n, fp, _ in card.waves_log)
            assert any(n == 4 and rp for n, _, rp in card.waves_log)


@pytest.mark.parametrize("owner", [True, False])
def test_sharded_run_batch_on_card_matches_cpu(cuda_device, small_world,
                                               owner):
    """``DistributedEngine.run_batch`` at 4 shards on the card equals the
    CPU run — whole rows and valid, all six ``DistStats`` fields — on a
    mixed batch per interface; the owner-masked probe launches exactly
    when owner masking is on."""
    store, loads = small_world
    qs = [q for load in QUERY_LOADS for q in loads[load]]
    dcfg = DistConfig(cap=2048, shard_cap=1024, owner_masking=owner)
    for interface in INTERFACES:
        cfg = EngineConfig(interface=interface)
        card = DistributedEngine(store, cfg, dcfg, n_shards=4)
        host = DistributedEngine(store, cfg, dcfg, n_shards=4, device="cpu")
        assert card.device.type == "cuda"
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        got = card.run_batch(qs)
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        want = host.run_batch(qs)
        assert ops.LAUNCHES == launches  # the CPU run launches nothing
        for i in range(len(qs)):
            for g, w in zip(got[:2], want[:2]):
                assert g[i].is_cuda
                np.testing.assert_array_equal(_np(g[i]), _np(w[i]))
            assert [int(x) for x in got[2][i]] == \
                [int(x) for x in want[2][i]]
        assert (launches["eqrange_owned"] > 0) == owner, interface
        assert launches["sorted_probe"] > 0 and launches["run_probe"] > 0
