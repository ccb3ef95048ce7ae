"""The port's concurrent scheduler: twins of the single-host cases of
``tests/test_scheduler.py``, the scheduler cases of
``tests/test_live_ingest.py`` and the vmap cases of
``tests/test_scheduler_prop.py``, run on the port's CPU path — every
response byte-identical to the port's serial ``QueryEngine.run`` (itself
pinned to the reference by ``tests/test_torch_engine.py``) — plus the
port's scheduler held directly against the reference's on one stream:
responses with all ten ``QueryStats`` fields, ``SchedMetrics``, and the
cache and planner keys, digests included."""

from functools import lru_cache

import numpy as np
import pytest

from _hyp import HAS_HYPOTHESIS, given, settings, st
from _torch import port_bgp, port_store, torch

import repro.core as rc
from repro.rdf import generate_query_load
from repro.rdf.queries import QueryLoadConfig
from repro_torch.core import (
    EngineConfig,
    FragmentCache,
    QueryEngine,
    QueryScheduler,
    SchedulerConfig,
    interleave_clients,
    results_as_numpy,
    stepper,
)
from repro_torch.core.engine import plan_query
from repro_torch.core.patterns import BGP, C, TriplePattern, V
from repro_torch.core.scheduler import SchedMetrics
from repro_torch.rdf import TripleStore, WatDivConfig, generate_watdiv
from repro_torch.rdf import generate_query_load as port_load
from repro_torch.rdf.queries import QueryLoadConfig as PortLoadConfig

LOADS = ["1-star", "2-stars", "3-stars", "paths", "union"]
INTERFACES = ["tpf", "brtpf", "spf", "endpoint"]
METRICS = ("requests", "jobs", "waves", "steps", "steps_skipped",
           "lane_steps", "active_lane_steps", "retries", "host_block_pulls")


def _sched(store, cfg, scfg=None, **kw):
    return QueryScheduler(store, cfg, scfg, device="cpu", **kw)


def _engine(store, cfg):
    return QueryEngine(store, cfg, device="cpu")


def _res(table):
    return results_as_numpy(table)


@pytest.fixture(scope="module")
def world(watdiv_small):
    """The reference's scale-10 store and two queries per load, as the
    port's store and BGPs."""
    g, ref_store = watdiv_small
    ref_qs = []
    for load in LOADS:
        ref_qs += generate_query_load(g, ref_store, load,
                                      QueryLoadConfig(n_queries=2))
    return port_store(ref_store), [port_bgp(q) for q in ref_qs]


@pytest.fixture(scope="module")
def serial_results(world):
    store, qs = world
    return {iface: [_engine(store, EngineConfig(interface=iface, cap=2048))
                    .run(q) for q in qs] for iface in INTERFACES}


def _assert_equivalent(serial, tables, stats, ctx):
    for i, (s_tbl, s_stats) in enumerate(serial):
        a = _res(s_tbl)
        b = _res(tables[i])
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, i)
        assert np.array_equal(a, b), (ctx, i)
        assert tuple(int(x) for x in s_stats)[:6] \
            == tuple(int(x) for x in stats[i])[:6], (ctx, i)


# --------------------------------------------------------------------------
# twins of tests/test_scheduler.py (single host)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("interface", INTERFACES)
def test_scheduler_byte_identical_to_serial(world, serial_results,
                                            interface):
    store, qs = world
    cfg = EngineConfig(interface=interface, cap=2048)
    for use_cache in (False, True):
        sched = _sched(store, cfg,
                       SchedulerConfig(lanes=4, use_cache=use_cache))
        tables, stats = sched.run_queries(qs)
        _assert_equivalent(serial_results[interface], tables, stats,
                           (interface, use_cache))
        if not use_cache:
            assert sched.cache.stats.total_hits == 0
            assert all(int(s.cache_hits) == 0 and int(s.nrs_saved) == 0
                       for s in stats)


def test_padding_lanes_are_noops(world, serial_results):
    store, qs = world
    cfg = EngineConfig(interface="spf", cap=2048)
    sched = _sched(store, cfg,
                   SchedulerConfig(lanes=8, collapse_duplicates=False))
    tables, stats = sched.run_queries([qs[0]] * 3)
    _assert_equivalent([serial_results["spf"][0]] * 3, tables, stats,
                       "padding")
    m = sched.metrics
    assert m.jobs == 3
    assert m.lane_steps > m.active_lane_steps
    assert m.pad_fraction > 0


def test_overflow_retry_inside_bucket(watdiv_small):
    g, ref_store = watdiv_small
    store = port_store(ref_store)
    qs = [port_bgp(q) for q in generate_query_load(
        g, ref_store, "2-stars", QueryLoadConfig(n_queries=3))]
    cfg = EngineConfig(interface="spf", cap=4, capacity_planner=False)
    serial = [_engine(store, cfg).run(q) for q in qs]
    for use_cache in (False, True):
        sched = _sched(store, cfg,
                       SchedulerConfig(lanes=4, use_cache=use_cache))
        tables, stats = sched.run_queries(qs)
        _assert_equivalent(serial, tables, stats, ("overflow", use_cache))
        assert sched.metrics.retries > 0
    sched = _sched(store, EngineConfig(interface="spf", cap=4),
                   SchedulerConfig(lanes=4))
    tables, stats = sched.run_queries(qs)
    _assert_equivalent(serial, tables, stats, "planner-on")
    assert sched.metrics.retries == 0


def test_cross_client_requests_hit_the_cache(watdiv_small):
    g, ref_store = watdiv_small
    store = port_store(ref_store)
    qs = [port_bgp(q) for q in generate_query_load(
        g, ref_store, "2-stars", QueryLoadConfig(n_queries=2))]
    n_clients = 4
    cfg = EngineConfig(interface="spf", cap=2048)
    sched = _sched(store, cfg, SchedulerConfig(lanes=8))
    served = sched.serve(interleave_clients(qs, n_clients))
    assert len(served) == len(qs) * n_clients
    eng = _engine(store, cfg)
    for i, (tbl, stats) in enumerate(served):
        ref_tbl, ref_stats = eng.run(qs[i // n_clients])
        assert np.array_equal(_res(tbl), _res(ref_tbl)), i
        assert tuple(int(x) for x in stats)[:6] \
            == tuple(int(x) for x in ref_stats)[:6], i
    assert sched.cache.stats.hit_rate > 0
    dup_stats = [s for i, (_, s) in enumerate(served) if i % n_clients]
    assert all(int(s.nrs_saved) == int(s.nrs) for s in dup_stats)
    assert all(int(s.ntb_saved) == int(s.ntb) for s in dup_stats)
    assert all(int(s.cache_misses) == 0 for s in dup_stats)
    primaries = [s for i, (_, s) in enumerate(served) if i % n_clients == 0]
    assert all(int(s.cache_misses) > 0 for s in primaries)


def test_engine_run_load_delegates_to_scheduler(world, serial_results):
    store, qs = world
    eng = _engine(store, EngineConfig(interface="spf", cap=2048))
    tables, stats = eng.run_load(qs[:4])
    _assert_equivalent(serial_results["spf"][:4], tables, stats, "run_load")
    sched = _sched(store, eng.cfg, planner=eng.planner)
    tables, stats = eng.run_load(qs[:4], scheduler=sched)
    _assert_equivalent(serial_results["spf"][:4], tables, stats, "shared")
    assert sched.metrics.requests == 4


def test_all_hit_wave_zero_host_materializations(world):
    store, qs = world
    qs = qs[:4]
    cfg = EngineConfig(interface="spf", cap=2048)
    sched = _sched(store, cfg, SchedulerConfig(lanes=8, cap_hints=False))
    first_tables, _ = sched.run_queries(qs)
    assert sched.metrics.host_block_pulls > 0
    steps0 = sched.metrics.steps
    pulls0 = sched.metrics.host_block_pulls
    skipped0 = sched.metrics.steps_skipped
    tables, stats = sched.run_queries(qs)
    assert sched.metrics.steps == steps0, "all-hit pass dispatched steps"
    assert sched.metrics.host_block_pulls == pulls0, \
        "all-hit pass pulled Omega blocks to the host"
    assert sched.metrics.steps_skipped > skipped0
    assert all(int(s.cache_misses) == 0 and int(s.cache_hits) > 0
               for s in stats)
    for a, b in zip(first_tables, tables):
        assert np.array_equal(_res(a), _res(b))


def test_snapshot_covers_the_serving_stack(world):
    store, qs = world
    sched = _sched(store, EngineConfig(interface="spf", cap=2048))
    sched.run_queries(qs[:2])
    snap = sched.snapshot()
    assert isinstance(snap, dict)
    assert snap["sched.requests"] == 2
    assert snap["cache.misses"] == sched.cache.stats.misses > 0
    assert snap["planner.observations"] == sched.planner.stats.observations


def test_expired_deadline_answers_none_with_stats_so_far(world,
                                                         serial_results):
    store, qs = world
    sched = _sched(store, EngineConfig(interface="spf", cap=2048))
    late = sched.submit(qs[2], deadline=0.0)  # long past
    ok = sched.submit(qs[0])
    results = sched.drain()
    table, stats = results[late]
    assert table is None and int(stats.n_results) == 0
    assert sched.metrics.deadline_expired == 1
    assert np.array_equal(_res(results[ok][0]),
                          _res(serial_results["spf"][0][0]))


# --------------------------------------------------------------------------
# the lane loop: skipped lanes leave the active lanes' outputs unchanged
# --------------------------------------------------------------------------

def test_lane_skip_leaves_active_lanes_unchanged(world):
    store, qs = world
    cfg = EngineConfig(interface="spf", cap=256)
    plan = next(p for p in (plan_query(store, q, cfg) for q in qs)
                if len(p.units) > 1)
    dev = store.device_arrays("cpu")
    up = plan.units[1]
    # seeds: the first unit's outputs of four lanes (one padding lane)
    n_lanes, cap, n_vars = 4, cfg.cap, plan.n_vars
    rows = torch.full((n_lanes, cap, n_vars), -1, dtype=torch.int32)
    valid = torch.zeros((n_lanes, cap), dtype=torch.bool)
    valid[:3, 0] = True
    consts = torch.tensor([plan.consts] * n_lanes, dtype=torch.int64)
    ovf = torch.zeros(n_lanes, dtype=torch.bool)
    r0 = stepper.unit_step(plan.units[0], store.radix)(
        dev, consts, rows, valid, ovf)
    rows, valid = r0[0].clone(), r0[1].clone()
    rows[1] = rows[1].flip(0)  # lane 1 differs from lanes 0 and 2
    valid[1] = valid[1].flip(0)
    every = stepper.unit_step(up, store.radix)(dev, consts, rows, valid, ovf)
    some = stepper.unit_step(up, store.radix)(dev, consts, rows, valid, ovf,
                                              active=[0, 2])
    for a, b in zip(every, some):
        assert torch.equal(a[[0, 2]], b[[0, 2]])
    assert not some[1][[1, 3]].any() and (some[0][[1, 3]] == -1).all()
    assert (some[4][[1, 3]] == 0).all() and (some[5][[1, 3]] == 0).all()
    assert torch.equal(some[2][[1, 3]], ovf[[1, 3]])
    assert int(every[5][0]) > 0  # the active lanes did real work


# --------------------------------------------------------------------------
# twins of tests/test_live_ingest.py's scheduler cases
# --------------------------------------------------------------------------

N_TERMS = 120
N_PREDS = 8


def _triples(rng, n):
    t = np.unique(np.stack([rng.integers(0, N_PREDS, n),
                            rng.integers(0, N_TERMS, n),
                            rng.integers(0, N_TERMS, n)], axis=1), axis=0)
    return t[:, 1], t[:, 0], t[:, 2]  # (s, p, o)


@pytest.fixture()
def store():
    rng = np.random.default_rng(11)
    s, p, o = _triples(rng, 1500)
    return TripleStore.build(s, p, o, n_terms=N_TERMS, n_predicates=N_PREDS)


def _apply_round(store, rng, n_ins=40, n_del=25):
    ms, mp, mo = store.merged_triples()
    idx = rng.choice(ms.shape[0], n_del, replace=False)
    ins = (rng.integers(0, N_TERMS, n_ins), rng.integers(0, N_PREDS, n_ins),
           rng.integers(0, N_TERMS, n_ins))
    store.apply_delta(insert=ins, delete=(ms[idx], mp[idx], mo[idx]))


def _rebuilt(store):
    ms, mp, mo = store.merged_triples()
    return TripleStore.build(ms, mp, mo, n_terms=store.n_terms,
                             n_predicates=store.n_predicates)


def _queries():
    return [
        BGP((TriplePattern(V(0), C(1), V(1)),), n_vars=2),
        BGP((TriplePattern(V(0), C(2), C(7)),), n_vars=1),
        BGP((TriplePattern(V(0), C(1), V(1)),
             TriplePattern(V(0), C(3), V(2))), n_vars=3),
        BGP((TriplePattern(V(0), C(2), V(1)),
             TriplePattern(V(1), C(4), V(2))), n_vars=3),
    ]


def test_scheduler_lowerings_byte_identity(store):
    """Lane waves over a delta store match the serial engine on the
    rebuilt store (the single-host lowering; the mesh and sharded ones
    are not part of the port yet)."""
    rng = np.random.default_rng(8)
    _apply_round(store, rng)
    _apply_round(store, rng)
    cfg = EngineConfig(interface="spf", cap=2048)
    ref_eng = _engine(_rebuilt(store), cfg)
    qs = _queries()
    want = [_res(ref_eng.run(q)[0]) for q in qs]
    sched = _sched(store, cfg, SchedulerConfig())
    tables, _ = sched.run_queries(qs)
    for q, t, w in zip(qs, tables, want):
        assert np.array_equal(_res(t), w), q


def test_inflight_wave_pins_old_epoch(store, monkeypatch):
    cfg = EngineConfig(interface="spf", cap=16, max_cap=1 << 14,
                       capacity_planner=False)
    q_big = BGP((TriplePattern(V(0), C(1), V(1)),), n_vars=2)  # overflows 16
    q_new = BGP((TriplePattern(V(0), C(2), C(7)),), n_vars=1)

    old_want = _res(_engine(_rebuilt(store), cfg).run(q_big)[0])
    assert old_want.shape[0] > 16

    ms, mp, mo = store.merged_triples()
    hit = np.nonzero((mp == 2) & (mo == 7))[0]
    assert hit.size > 0
    write = dict(delete=(ms[hit[:1]], mp[hit[:1]], mo[hit[:1]]),
                 insert=([N_TERMS - 1], [2], [7]))

    sched = _sched(store, cfg, SchedulerConfig(cap_hints=False))
    fired = {"n": 0}
    orig = QueryScheduler._run_wave

    def spy(self, jobs, results):
        out = orig(self, jobs, results)
        fired["n"] += 1
        if fired["n"] == 1:  # queue the write during the first wave
            self.submit_write(**write)
        return out

    monkeypatch.setattr(QueryScheduler, "_run_wave", spy)
    r_big = sched.submit(q_big)
    r_new = sched.submit(q_new)
    results = sched.drain()

    assert np.array_equal(_res(results[r_big][0]), old_want)
    assert sched.metrics.retries > 0
    new_want = _res(_engine(_rebuilt(store), cfg).run(q_new)[0])
    assert np.array_equal(_res(results[r_new][0]), new_want)
    monkeypatch.setattr(QueryScheduler, "_run_wave", orig)
    t2, _ = sched.run_queries([q_big])
    assert np.array_equal(
        _res(t2[0]), _res(_engine(_rebuilt(store), cfg).run(q_big)[0]))


def test_pinned_view_outlives_writes_and_compaction(store):
    """An epoch view (what an in-flight job pins) stays alive and
    unchanged while the store takes writes and compacts: the device view
    of a new epoch is made of new tensors, never written into old ones."""
    rng = np.random.default_rng(3)
    _apply_round(store, rng)
    pinned = store.device_arrays("cpu")
    before = [t.clone() for t in pinned]
    _apply_round(store, rng)
    after_write = store.device_arrays("cpu")
    store.compact()
    after_compact = store.device_arrays("cpu")
    for t, b in zip(pinned, before):
        assert torch.equal(t, b)
    assert any(not torch.equal(a, b) for a, b in zip(after_write, before)
               if a.shape == b.shape) or \
        any(a.shape != b.shape for a, b in zip(after_write, before))
    assert after_compact.key_ps_pso.data_ptr() != pinned.key_ps_pso.data_ptr()


def test_cache_and_hwm_carryover(store):
    cfg = EngineConfig(interface="spf", cap=2048)
    q_untouched = BGP((TriplePattern(V(0), C(1), V(1)),
                       TriplePattern(V(0), C(3), V(2))), n_vars=3)
    q_touched = BGP((TriplePattern(V(0), C(4), V(1)),), n_vars=2)
    sched = _sched(store, cfg)
    sched.run_queries([q_untouched, q_touched])
    _, warm = sched.run_queries([q_untouched, q_touched])
    assert all(s.cache_misses == 0 for s in warm)
    hwm_before = len(sched.planner._hwm)
    assert hwm_before > 0

    sched.ingest(insert=([10, 11], [4, 4], [12, 13]))
    assert sched.cache.stats.carryover > 0
    assert sched.cache.stats.swept > 0
    assert sched.planner.stats.carryover > 0

    _, post = sched.run_queries([q_untouched, q_touched])
    assert post[0].cache_misses == 0
    assert post[1].cache_misses > 0
    assert any(k[3] == store.epoch for k in sched.planner._hwm)


def test_compaction_carries_everything(store):
    rng = np.random.default_rng(9)
    _apply_round(store, rng)
    cfg = EngineConfig(interface="spf", cap=2048)
    qs = _queries()
    sched = _sched(store, cfg)
    want = [_res(t) for t in sched.run_queries(qs)[0]]
    sched.run_queries(qs)

    assert store.delta_size > 0
    store.compact()
    sched._refresh_epoch()
    assert sched.cache.stats.swept == 0
    tables, stats = sched.run_queries(qs)
    assert all(s.cache_misses == 0 for s in stats)
    for t, w in zip(tables, want):
        assert np.array_equal(_res(t), w)


def test_tombstoned_triple_never_reappears_from_cache(store):
    cfg = EngineConfig(interface="spf", cap=2048)
    q = BGP((TriplePattern(V(0), C(1), V(1)),), n_vars=2)
    sched = _sched(store, cfg)
    t0, _ = sched.run_queries([q])
    rows0 = _res(t0[0])
    assert rows0.shape[0] > 0
    s_del, o_del = int(rows0[0, 0]), int(rows0[0, 1])

    sched.ingest(delete=([s_del], [1], [o_del]))
    t1, _ = sched.run_queries([q])
    rows1 = _res(t1[0])
    assert not ((rows1[:, 0] == s_del) & (rows1[:, 1] == o_del)).any()
    want = _res(_engine(_rebuilt(store), cfg).run(q)[0])
    assert np.array_equal(rows1, want)


# --------------------------------------------------------------------------
# twins of tests/test_scheduler_prop.py's vmap cases
# --------------------------------------------------------------------------

LANES = [1, 2, 4, 8]
CAP = 512


@lru_cache(maxsize=1)
def _env():
    g = generate_watdiv(WatDivConfig(scale=16))
    store = TripleStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                              n_predicates=g.n_predicates)
    queries = []
    for load in ("1-star", "2-stars", "paths"):
        queries += port_load(g, store, load, PortLoadConfig(n_queries=2))
    return store, queries


@lru_cache(maxsize=None)
def _serial(interface: str, qi: int):
    store, queries = _env()
    table, stats = _engine(store, EngineConfig(interface=interface,
                                               cap=CAP)).run(queries[qi])
    return _res(table), tuple(int(x) for x in stats)[:6]


def _check_stream(stream, interface, lanes, use_cache, collapse):
    store, queries = _env()
    sched = _sched(store, EngineConfig(interface=interface, cap=CAP),
                   SchedulerConfig(lanes=lanes, use_cache=use_cache,
                                   collapse_duplicates=collapse))
    served = sched.serve([(c, queries[qi]) for c, qi in stream])
    for (c, qi), (table, stats) in zip(stream, served):
        ref_rows, ref_gross = _serial(interface, qi)
        got = _res(table)
        assert got.dtype == ref_rows.dtype and got.shape == ref_rows.shape
        assert np.array_equal(got, ref_rows)
        assert tuple(int(x) for x in stats)[:6] == ref_gross
    if not use_cache:
        # the reference's property asserts total_hits == 0, which
        # collapsing breaks (shared hits count in it); no stored entry
        # may serve a request with the cache off
        assert sched.cache.stats.hits == 0


def test_fixed_random_stream_parity():
    rng = np.random.default_rng(0)
    _, queries = _env()
    stream = [(int(rng.integers(0, 4)), int(rng.integers(0, len(queries))))
              for _ in range(12)]
    _check_stream(stream, "spf", lanes=4, use_cache=True, collapse=True)
    _check_stream(stream, "spf", lanes=4, use_cache=False, collapse=False)


def test_hypothesis_shim_mode_is_consistent():
    fn = test_scheduler_parity_over_random_streams
    assert callable(fn)
    if not HAS_HYPOTHESIS:
        with pytest.raises(pytest.skip.Exception):
            fn()


@given(st.lists(st.tuples(st.integers(0, 3), st.integers(0, 5)),
                min_size=1, max_size=10),
       st.sampled_from(INTERFACES),
       st.sampled_from(LANES),
       st.booleans(), st.booleans())
@settings(max_examples=12, deadline=None)
def test_scheduler_parity_over_random_streams(stream, interface, lanes,
                                              use_cache, collapse):
    _check_stream(stream, interface, lanes, use_cache, collapse)


@given(st.lists(st.integers(0, 5), min_size=1, max_size=8),
       st.sampled_from(LANES))
@settings(max_examples=10, deadline=None)
def test_warm_cache_stream_parity(qis, lanes):
    store, queries = _env()
    sched = _sched(store, EngineConfig(interface="spf", cap=CAP),
                   SchedulerConfig(lanes=lanes))
    for _ in range(2):
        tables, stats = sched.run_queries([queries[qi] for qi in qis])
        for qi, table, st_ in zip(qis, tables, stats):
            ref_rows, ref_gross = _serial("spf", qi)
            assert np.array_equal(_res(table), ref_rows)
            assert tuple(int(x) for x in st_)[:6] == ref_gross


# --------------------------------------------------------------------------
# the port's scheduler against the reference's, directly
# --------------------------------------------------------------------------

@pytest.mark.parametrize("interface", ["spf", "tpf"])
def test_scheduler_matches_reference_scheduler(watdiv_small, interface):
    """One 4-client stream through both packages' schedulers, lanes=4 and
    a forced overflow ladder (cap 16, planner off), drained twice (cold,
    then warm with replayed waves): every response's rows, overflow and
    all ten ``QueryStats`` fields, the scheduler metrics, and the cache
    and planner keys — digests included — are the reference's."""
    g, ref_store = watdiv_small
    ref_qs = []
    for load in ("1-star", "2-stars", "paths"):
        ref_qs += generate_query_load(g, ref_store, load,
                                      QueryLoadConfig(n_queries=2))
    ref_stream = rc.interleave_clients(ref_qs, 4)
    stream = [(c, port_bgp(q)) for c, q in ref_stream]
    store = port_store(ref_store)
    kw = dict(interface=interface, cap=16, capacity_planner=False)
    ref_sched = rc.QueryScheduler(ref_store, rc.EngineConfig(**kw),
                                  rc.SchedulerConfig(lanes=4))
    sched = _sched(store, EngineConfig(**kw), SchedulerConfig(lanes=4))
    for drain in ("cold", "warm"):
        want = ref_sched.serve(ref_stream)
        got = sched.serve(stream)
        for i, ((wt, ws), (gt, gs)) in enumerate(zip(want, got)):
            assert np.array_equal(_res(gt), rc.results_as_numpy(wt)), \
                (drain, i)
            assert bool(gt.overflow) == bool(np.asarray(wt.overflow))
            assert tuple(int(x) for x in gs) == tuple(int(x) for x in ws), \
                (drain, i)
        for f in METRICS:
            assert getattr(sched.metrics, f) == getattr(ref_sched.metrics, f), \
                (drain, f)
        assert list(sched.cache._entries) == list(ref_sched.cache._entries)
        assert list(sched.cache._neg) == list(ref_sched.cache._neg)
        assert list(sched.planner._hwm.items()) \
            == list(ref_sched.planner._hwm.items())
    assert sched.metrics.retries > 0 and sched.metrics.steps_skipped > 0
    assert any(k[-1][0] == "fp32x4" for k in sched.cache._entries)
    assert set(SchedMetrics._FIELDS) <= set(rc.scheduler.SchedMetrics._FIELDS)


def test_shared_cache_serves_a_second_scheduler(world):
    store, qs = world
    cfg = EngineConfig(interface="spf", cap=2048)
    cache = FragmentCache()
    _sched(store, cfg, SchedulerConfig(cap_hints=False),
           cache=cache).run_queries(qs[:4])
    second = _sched(store, cfg, SchedulerConfig(cap_hints=False),
                    cache=cache)
    _, stats = second.run_queries(qs[:4])
    assert all(int(s.cache_misses) == 0 for s in stats)
    assert second.metrics.steps == 0
