"""The port's fragment cache and request canonicalization: twins of
``tests/test_fragcache.py`` (LRU mechanics, admission, the negative side
table, epoch invalidation and carry-over, keys) run on the port, plus the
port's cache and keys held directly against the JAX reference's on the
same inputs."""

import numpy as np
import pytest

from _torch import port_bgp, port_store, torch  # noqa: F401

import repro.core as rc
from repro.core import fragcache as ref_fragcache
from repro.core import server as ref_server
from repro.rdf import generate_query_load
from repro.rdf.queries import QueryLoadConfig
from repro_torch.core import (
    C,
    EngineConfig,
    QueryEngine,
    QueryScheduler,
    V,
    results_as_numpy,
)
from repro_torch.core.engine import plan_query
from repro_torch.core.fragcache import (
    CacheStats,
    CountMinSketch,
    FragmentCache,
    FragmentEntry,
    replay,
)
from repro_torch.core.patterns import BGP, TriplePattern
from repro_torch.core.server import unit_digest_key, unit_io, \
    unit_request_key
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.rdf import TripleStore


def _entry(n_out=2, n_write=1):
    return FragmentEntry(
        src_row=np.arange(n_out, dtype=np.int32),
        written=np.full((n_out, n_write), 7, np.int32),
        overflow=False, ops=3)


def _sched(store, cfg, **kw):
    return QueryScheduler(store, cfg, device="cpu", **kw)


def test_lru_eviction_order():
    cache = FragmentCache(capacity=2)
    cache.put(("a",), _entry())
    cache.put(("b",), _entry())
    assert cache.get(("a",)) is not None  # refresh "a"
    cache.put(("c",), _entry())  # evicts LRU = "b"
    assert cache.get(("b",)) is None
    assert cache.get(("a",)) is not None
    assert cache.get(("c",)) is not None
    assert cache.stats.evictions == 1
    assert len(cache) == 2


def test_cache_stats_accounting():
    cache = FragmentCache(capacity=8)
    assert cache.get(("x",)) is None
    cache.put(("x",), _entry())
    assert cache.get(("x",)) is not None
    cache.note_shared_hit(3)
    st = cache.stats
    assert (st.misses, st.hits, st.shared_hits) == (1, 1, 3)
    assert st.total_hits == 4
    assert abs(st.hit_rate - 4 / 5) < 1e-12
    cache.clear()
    assert len(cache) == 0 and cache.stats == CacheStats()


def test_replay_materialises_delta():
    entry = FragmentEntry(src_row=np.array([1, 0, 1], np.int32),
                          written=np.array([[9], [8], [7]], np.int32),
                          overflow=False, ops=0)
    seed = np.array([[10, -1], [20, -1]], np.int32)
    rows, valid = replay(entry, seed, cap=5, n_vars=2, write_cols=(1,))
    np.testing.assert_array_equal(rows[:3], [[20, 9], [10, 8], [20, 7]])
    assert valid.tolist() == [True, True, True, False, False]
    np.testing.assert_array_equal(rows[3:], -np.ones((2, 2), np.int32))


def _tiny_store():
    # triples: (s, p, o) — two predicates; subject 3 exists so star results
    # (object 3) can be chained into a second unit
    s = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    p = np.array([0, 1, 0, 1, 0, 1, 0, 1])
    o = np.array([3, 4, 3, 5, 3, 4, 4, 5])
    return TripleStore.build(s, p, o, n_terms=6, n_predicates=2)


Q1 = BGP((TriplePattern(V(0), C(0), V(1)),
          TriplePattern(V(0), C(1), C(4))), n_vars=2)
Q2 = BGP((TriplePattern(V(1), C(0), V(0)),
          TriplePattern(V(1), C(1), C(4))), n_vars=2)


def test_var_renaming_canonicalizes_across_queries():
    """The same star asked with different variable numbers is one request."""
    store = _tiny_store()
    cfg = EngineConfig(interface="spf")
    p1 = plan_query(store, Q1, cfg)
    p2 = plan_query(store, Q2, cfg)
    assert p1.signature != p2.signature  # different var layout...
    io1, io2 = unit_io(p1.units[0]), unit_io(p2.units[0])
    assert io1.canon_sig == io2.canon_sig  # ...same canonical request
    c1 = tuple(int(np.asarray(p1.consts)[i]) for i in io1.const_idx)
    c2 = tuple(int(np.asarray(p2.consts)[i]) for i in io2.const_idx)
    empty = np.zeros((1, 0), np.int32)
    assert unit_request_key(io1, c1, empty, 64) \
        == unit_request_key(io2, c2, empty, 64)


def test_cross_query_hits_through_scheduler():
    """Two var-renamed copies of one query: the second's units are all
    served from fragments the first one computed."""
    store = _tiny_store()
    cfg = EngineConfig(interface="spf", cap=64)
    sched = _sched(store, cfg)
    tables, stats = sched.run_queries([Q1, Q2])
    assert int(stats[0].cache_misses) > 0
    assert int(stats[1].cache_hits) == len(plan_query(store, Q2, cfg).units)
    assert int(stats[1].nrs_saved) == int(stats[1].nrs)
    eng = QueryEngine(store, cfg, device="cpu")
    for q, tbl in zip([Q1, Q2], tables):
        ref = results_as_numpy(eng.run(q)[0])
        assert np.array_equal(results_as_numpy(tbl), ref)


def test_partially_warm_cache_replays_after_device_step():
    """A unit step rebinds the wave state to the step's outputs; a later
    unit whose active lanes all hit then replays onto that state."""
    store = _tiny_store()
    cfg = EngineConfig(interface="spf", cap=64)
    q = BGP((TriplePattern(V(0), C(0), V(1)),
             TriplePattern(V(0), C(1), C(4)),
             TriplePattern(V(1), C(1), V(2))), n_vars=3)
    sched = _sched(store, cfg)
    tables, _ = sched.run_queries([q])
    ref = np.array(results_as_numpy(tables[0]))
    assert ref.shape[0] >= 1
    # evict the first unit's fragment (insertion order) but keep the rest:
    # next serve misses unit 0 (device step) and all-hits unit 1 (replay)
    sched.cache._entries.popitem(last=False)
    tables2, stats2 = sched.run_queries([q])
    assert int(stats2[0].cache_hits) > 0 and int(stats2[0].cache_misses) > 0
    assert np.array_equal(results_as_numpy(tables2[0]), ref)


def test_freq_admission_keeps_hot_fragments():
    cache = FragmentCache(capacity=2)  # default policy="freq"
    cache.put(("hot-a",), _entry())
    cache.put(("hot-b",), _entry())
    for _ in range(5):
        assert cache.get(("hot-a",)) is not None
        assert cache.get(("hot-b",)) is not None
    for i in range(20):  # cold scan: 20 unique never-repeated keys
        cache.put((f"cold-{i}",), _entry())
    assert cache.get(("hot-a",)) is not None
    assert cache.get(("hot-b",)) is not None
    assert cache.stats.admission_rejects == 20
    assert cache.stats.evictions == 0
    lru = FragmentCache(capacity=2, policy="lru")
    lru.put(("hot-a",), _entry())
    for _ in range(5):
        lru.get(("hot-a",))
    for i in range(3):
        lru.put((f"cold-{i}",), _entry())
    assert lru.get(("hot-a",)) is None


def test_freq_sketch_ages_by_halving():
    cache = FragmentCache(capacity=1)  # CMS window = 16 * capacity touches
    for _ in range(8):
        cache.get(("old-hot",))
    assert cache._sketch.estimate(("old-hot",)) == 8
    for i in range(16 * cache.capacity + 4):
        cache.get((f"filler-{i}",))
    assert cache._sketch.estimate(("old-hot",)) < 8
    exact = FragmentCache(capacity=1, sketch="exact")
    for _ in range(8):
        exact.get(("old-hot",))
    for i in range(8 * exact.capacity + 4):
        exact.get((f"filler-{i}",))
    assert exact._sketch.estimate(("old-hot",)) < 8


def test_cms_is_constant_space_and_admission_matches_exact():
    rng = np.random.default_rng(7)
    caches = {kind: FragmentCache(capacity=8, sketch=kind)
              for kind in ("cms", "exact")}
    keys = [(f"k{i}",) for i in range(16)]
    trace = [keys[int(rng.integers(0, len(keys)))] for _ in range(100)]
    for t, key in enumerate(trace):
        decisions = {}
        for kind, cache in caches.items():
            cache.get(key)
            if t % 3 == 0:
                cache.put(key, _entry())
            decisions[kind] = (sorted(k[0] for k in cache._entries),
                               cache.stats.admission_rejects,
                               cache.stats.insertions)
        assert decisions["cms"] == decisions["exact"], (t, decisions)
    sk = CountMinSketch(capacity=4)
    nbytes = sk._table.nbytes
    for i in range(10_000):
        sk.add((f"scan-{i}",))
    assert sk._table.nbytes == nbytes


def test_lazy_epoch_check_is_a_raw_key_backstop():
    cache = FragmentCache(capacity=8)
    cache.put(("sig", 0), _entry(), epoch=0)  # key distinct per epoch
    assert cache.get(("sig", 1), epoch=1) is None  # new-epoch key: plain miss
    assert cache.stats.stale_evictions == 0  # lazy branch never fired
    assert cache.sync_epoch(1) == 1  # the sweep reclaims the stale entry
    assert cache.stats.stale_evictions == 1
    cache.put(("raw",), _entry(), epoch=1)
    assert cache.get(("raw",), epoch=2) is None
    assert cache.stats.stale_evictions == 2


def test_negative_results_cached_in_side_table():
    cache = FragmentCache(capacity=1)
    empty = FragmentEntry(src_row=np.zeros((0,), np.int32),
                          written=np.zeros((0, 2), np.int32),
                          overflow=False, ops=7)
    cache.put(("full",), _entry())
    cache.put(("neg-1",), empty)
    cache.put(("neg-2",), empty)
    assert len(cache) == 1 and cache.n_negative == 2  # no main eviction
    got = cache.get(("neg-1",))
    assert got is not None and got.n_out == 0 and got.ops == 7
    assert cache.stats.neg_hits == 1 and cache.stats.hits == 1
    rows, valid = replay(got, np.zeros((3, 2), np.int32), cap=4, n_vars=2,
                         write_cols=(1,))
    assert valid.sum() == 0 and (rows == -1).all()
    small = FragmentCache(capacity=4, neg_capacity=2)
    for i in range(3):
        small.put((f"n{i}",), empty)
    assert small.n_negative == 2 and small.get(("n0",)) is None


def test_negative_overflow_charged_to_neg_evictions_not_main():
    empty = _entry(n_out=0)
    small = FragmentCache(capacity=4, neg_capacity=2)
    for i in range(5):
        small.put((f"n{i}",), empty)
    assert small.stats.neg_evictions == 3
    assert small.stats.evictions == 0
    for i in range(6):
        small.put((f"p{i}",), _entry(n_out=1))
    assert small.stats.evictions == 2
    assert small.stats.neg_evictions == 3


def test_epoch_bump_invalidates_exactly_stale_entries():
    cache = FragmentCache(capacity=8)
    empty = FragmentEntry(src_row=np.zeros((0,), np.int32),
                          written=np.zeros((0, 1), np.int32),
                          overflow=False, ops=0)
    cache.put(("old",), _entry(), epoch=0)
    cache.put(("old-neg",), empty, epoch=0)
    cache.put(("new",), _entry(), epoch=1)
    assert cache.get(("old",), epoch=1) is None
    assert cache.stats.stale_evictions == 1
    assert cache.get(("new",), epoch=1) is not None
    dropped = cache.invalidate_stale(epoch=1)
    assert dropped == 1  # just ("old-neg",); ("new",) survives
    assert cache.stats.stale_evictions == 2
    assert cache.get(("new",), epoch=1) is not None
    assert cache.get(("old-neg",), epoch=1) is None
    assert cache.stats.bytes_stored == cache.get(("new",), epoch=1).nbytes


def test_store_epoch_bump_invalidates_through_scheduler():
    store = _tiny_store()
    cfg = EngineConfig(interface="spf", cap=64)
    sched = _sched(store, cfg)
    t1, _ = sched.run_queries([Q1])
    _, warm = sched.run_queries([Q1])
    assert int(warm[0].cache_hits) > 0 and int(warm[0].cache_misses) == 0
    store.bump_epoch()
    t3, cold = sched.run_queries([Q1])
    assert int(cold[0].cache_misses) > 0 and int(cold[0].cache_hits) == 0
    assert sched.cache.stats.stale_evictions > 0
    assert np.array_equal(results_as_numpy(t1[0]), results_as_numpy(t3[0]))
    _, rewarm = sched.run_queries([Q1])
    assert int(rewarm[0].cache_hits) > 0


def test_fresh_scheduler_on_shared_cache_sweeps_after_bump():
    store = _tiny_store()
    cfg = EngineConfig(interface="spf", cap=64)
    first = _sched(store, cfg)
    first.run_queries([Q1])
    assert len(first.cache) + first.cache.n_negative > 0
    store.bump_epoch()
    fresh = _sched(store, cfg, cache=first.cache)
    _, stats = fresh.run_queries([Q1])
    assert fresh.cache.stats.stale_evictions > 0
    assert int(stats[0].cache_misses) > 0  # recomputed at the new epoch


def test_negative_caching_through_scheduler():
    store = _tiny_store()
    cfg = EngineConfig(interface="spf", cap=64)
    # predicate 0 never has object 5 -> empty star fragment
    q = BGP((TriplePattern(V(0), C(0), C(5)),), n_vars=1)
    sched = _sched(store, cfg)
    _, first = sched.run_queries([q])
    assert int(first[0].n_results) == 0
    _, again = sched.run_queries([q])
    assert int(again[0].cache_hits) > 0 and int(again[0].cache_misses) == 0
    assert int(again[0].nrs_saved) == int(again[0].nrs) > 0
    assert sched.cache.stats.neg_hits > 0
    assert sched.cache.n_negative > 0 and len(sched.cache) == 0


def test_key_differs_on_omega_and_cap():
    store = _tiny_store()
    cfg = EngineConfig(interface="spf")
    plan = plan_query(store, Q1, cfg)
    io = unit_io(plan.units[0])
    consts = tuple(int(np.asarray(plan.consts)[i]) for i in io.const_idx)
    empty = np.zeros((1, 0), np.int32)
    base = unit_request_key(io, consts, empty, 64)
    assert unit_request_key(io, consts, empty, 128) != base
    assert unit_request_key(io, consts, np.zeros((2, 0), np.int32), 64) != base
    assert unit_request_key(io, (99,) + consts[1:], empty, 64) != base
    assert unit_request_key(io, consts, empty, 64, epoch=1) != base


# --------------------------------------------------------------------------
# the port against the reference, directly
# --------------------------------------------------------------------------

def _ref_entry(e):
    return ref_fragcache.FragmentEntry(e.src_row, e.written, e.overflow,
                                       e.ops, e.epoch, e.peak)


@pytest.mark.parametrize("policy,sketch", [("freq", "cms"),
                                           ("freq", "exact"),
                                           ("lru", "cms")])
def test_cache_matches_reference_on_one_sequence(policy, sketch):
    """Both packages' caches fed the same seeded sequence of lookups,
    insertions (positive and negative), shared hits and epoch sweeps with
    carry-over end with equal key lists, entries and statistics."""
    rng = np.random.default_rng(5)
    port = FragmentCache(capacity=6, neg_capacity=3, policy=policy,
                         sketch=sketch)
    ref = ref_fragcache.FragmentCache(capacity=6, neg_capacity=3,
                                      policy=policy, sketch=sketch)
    epoch = 0
    for t in range(400):
        pred = int(rng.integers(0, 4))
        key = (("sig", int(rng.integers(0, 3))), (pred, 7), 64, epoch,
               int(rng.integers(0, 12)))
        op = rng.random()
        if op < 0.45:
            a, b = port.get(key, epoch), ref.get(key, epoch)
            assert (a is None) == (b is None), t
            if a is not None:
                assert a.ops == b.ops and np.array_equal(a.src_row, b.src_row)
        elif op < 0.9:
            n_out = int(rng.integers(0, 4))
            e = FragmentEntry(rng.integers(0, 9, n_out).astype(np.int32),
                              rng.integers(0, 9, (n_out, 1)).astype(np.int32),
                              bool(rng.integers(0, 2)), int(rng.integers(9)),
                              epoch, int(rng.integers(9)))
            port.put(key, e, epoch)
            ref.put(key, _ref_entry(e), epoch)
        elif op < 0.95:
            port.note_shared_hit(2)
            ref.note_shared_hit(2)
        else:
            epoch += 1
            changed = None if rng.random() < 0.3 else {pred}
            assert port.sync_epoch(epoch, changed) \
                == ref.sync_epoch(epoch, changed)
    assert list(port._entries) == list(ref._entries)
    assert list(port._neg) == list(ref._neg)
    for k, e in port._entries.items():
        r = ref._entries[k]
        assert (e.overflow, e.ops, e.epoch, e.peak) \
            == (r.overflow, r.ops, r.epoch, r.peak)
        assert np.array_equal(e.src_row, r.src_row)
        assert np.array_equal(e.written, r.written)
    assert port._neg == ref._neg
    want = ref.stats.as_dict()
    assert want.pop("wire_corrupt") == 0  # the reference's wire counter
    assert port.stats.as_dict() == want
    assert port.stats.carryover > 0 and port.stats.swept > 0
    assert port.synced_epoch == ref.synced_epoch == epoch


def test_replay_matches_reference():
    rng = np.random.default_rng(2)
    seed = rng.integers(0, 100, (9, 4)).astype(np.int32)
    e = FragmentEntry(rng.integers(0, 9, 13).astype(np.int32),
                      rng.integers(0, 100, (13, 2)).astype(np.int32),
                      False, 0)
    got = replay(e, seed, 32, 4, (3, 1))
    want = ref_fragcache.replay(_ref_entry(e), seed, 32, 4, (3, 1))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_unit_keys_match_reference(watdiv_small):
    """``unit_io``, ``unit_request_key`` and ``unit_digest_key`` of every
    unit of every load's plans equal the reference's: the port's cache
    keys name the same requests."""
    g, ref_store = watdiv_small
    store = port_store(ref_store)
    block = np.arange(12, dtype=np.int32).reshape(4, 3)
    n = 0
    for load in ("1-star", "2-stars", "3-stars", "paths", "union"):
        for q in generate_query_load(g, ref_store, load,
                                     QueryLoadConfig(n_queries=2)):
            for iface in ("tpf", "spf"):
                rp = rc.engine.plan_query(ref_store, q,
                                          rc.EngineConfig(interface=iface))
                pp = plan_query(store, port_bgp(q),
                                EngineConfig(interface=iface))
                for ru, pu in zip(rp.units, pp.units):
                    rio, pio = ref_server.unit_io(ru), unit_io(pu)
                    assert tuple(pio) == tuple(rio)
                    cv = tuple(int(pp.consts[i]) for i in pio.const_idx)
                    assert unit_request_key(pio, cv, block, 64, 3) \
                        == ref_server.unit_request_key(rio, cv, block, 64, 3)
                    dig = (1, 2**32 - 1, 0, 7)
                    assert unit_digest_key(pio, cv, 64, 3, 4, dig) \
                        == ref_server.unit_digest_key(rio, cv, 64, 3, 4, dig)
                    n += 1
    assert n > 30


def test_registry_reset_clears_a_prefix():
    """``FragmentCache.clear`` zeroes the cache's own fields (the
    ``cache.`` prefix) on a registry it shares, and nothing else."""
    reg = MetricsRegistry()
    cache = FragmentCache(registry=reg)
    cache.stats.hits += 3
    cache.stats.misses += 1
    reg.inc("sched.steps", 2)
    reg.observe("sched.lat", 1.0)
    cache.clear()
    assert cache.stats == CacheStats() and len(cache) == 0
    snap = reg.snapshot()
    assert snap["sched.steps"] == 2 and snap["sched.lat"]["count"] == 1
    assert all(v == 0 for k, v in snap.items() if k.startswith("cache."))
