"""The CUDA kernels and the engine on the card (over a static store and a
live one), held against the port's own plain CPU path (exact).  Every test here needs an NVIDIA GPU: it
carries the ``cuda`` marker and skips where there is none.

This file imports only torch, numpy and ``repro_torch``, so it runs on a
machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

from _torch import cuda_device, torch  # noqa: F401  (cuda_device: fixture)

from repro_torch.core import INTERFACES, EngineConfig, QueryEngine, \
    results_as_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.delta_probe import delta_probe_cuda, delta_probe_plain
from repro_torch.kernels.run_probe import run_probe_cuda, run_probe_plain
from repro_torch.kernels.sorted_probe import (sorted_probe_cuda,
                                              sorted_probe_plain)
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
    assert min(ops.LAUNCHES.values()) > 0
