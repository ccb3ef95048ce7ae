"""The port's live store against the JAX package's, exactly: the delta
overlay's set semantics, merged triples, compaction, changed-predicate
tracking, the merged-exact planning metadata, and ``QueryEngine.run`` /
``eval_unit`` over a store with a delta — on the same writes in both
packages (twins of ``tests/test_live_ingest.py``'s store and engine
cases, plus the port held directly against the reference).

The port keeps its delta columns at their exact lengths where the
reference pads them to a power-of-two bucket; the tests below show the
padding invisible in results, and feed the port the reference's padded
columns too."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch import DELTA_FIELDS, HOST_FIELDS, bgp_tuples, port_bgp, \
    port_store, torch

import repro.core as rc
from repro.core import bindings as ref_bindings
from repro.core import server as ref_server
from repro.core import patterns as ref_patterns
from repro.rdf import generate_query_load
from repro.rdf.queries import QueryLoadConfig
from repro.rdf.store import TripleStore as RefStore
from repro_torch.core import EngineConfig, QueryEngine, bindings, engine, \
    results_as_numpy, server
from repro_torch.core.patterns import BGP, C, TriplePattern, V
from repro_torch.rdf.store import StoreArrays, TripleStore
from repro_torch.rdf.writes import WriteFeed

N_TERMS = 120
N_PREDS = 8
LOADS = ("1-star", "2-stars", "3-stars", "paths", "union")
INTERFACES = ("tpf", "brtpf", "spf", "endpoint")


def _triples(rng, n, n_terms=N_TERMS, n_preds=N_PREDS):
    t = np.unique(np.stack([rng.integers(0, n_preds, n),
                            rng.integers(0, n_terms, n),
                            rng.integers(0, n_terms, n)], axis=1), axis=0)
    return t[:, 1], t[:, 0], t[:, 2]  # (s, p, o)


@pytest.fixture()
def store():
    rng = np.random.default_rng(11)
    s, p, o = _triples(rng, 1500)
    return TripleStore.build(s, p, o, n_terms=N_TERMS, n_predicates=N_PREDS)


@pytest.fixture()
def pair():
    """The same random store in both packages."""
    rng = np.random.default_rng(11)
    s, p, o = _triples(rng, 1500)
    return (RefStore.build(s, p, o, n_terms=N_TERMS, n_predicates=N_PREDS),
            TripleStore.build(s, p, o, n_terms=N_TERMS,
                              n_predicates=N_PREDS))


def _round(rng, merged, n_ins=40, n_del=25):
    """One write batch: delete live triples, insert fresh random ones."""
    ms, mp, mo = merged
    idx = rng.choice(ms.shape[0], n_del, replace=False)
    ins = (rng.integers(0, N_TERMS, n_ins), rng.integers(0, N_PREDS, n_ins),
           rng.integers(0, N_TERMS, n_ins))
    return dict(insert=ins, delete=(ms[idx], mp[idx], mo[idx]))


def _rebuilt(store):
    ms, mp, mo = store.merged_triples()
    return TripleStore.build(ms, mp, mo, n_terms=store.n_terms,
                             n_predicates=store.n_predicates)


def _queries():
    """Branch-case coverage: free scan, bound-object scan, a star with a
    filter branch, a two-star path, and bound-variable probes/scans."""
    return [
        BGP((TriplePattern(V(0), C(1), V(1)),), n_vars=2),
        BGP((TriplePattern(V(0), C(2), C(7)),), n_vars=1),
        BGP((TriplePattern(V(0), C(1), V(1)),
             TriplePattern(V(0), C(3), V(2))), n_vars=3),
        BGP((TriplePattern(V(0), C(2), V(1)),
             TriplePattern(V(1), C(4), V(2))), n_vars=3),
        BGP((TriplePattern(V(0), C(5), V(1)),
             TriplePattern(V(0), C(6), V(1))), n_vars=2),
        BGP((TriplePattern(V(0), C(3), V(1)),
             TriplePattern(V(2), C(0), V(1))), n_vars=3),
        BGP((TriplePattern(V(0), C(2), V(1)),
             TriplePattern(V(1), C(4), C(9))), n_vars=2),
    ]


def _ref_bgp(q):
    """A port BGP as the reference's."""
    pats, n_vars = bgp_tuples(q)
    rp = ref_patterns
    return rp.BGP(tuple(rp.TriplePattern(*(rp.V(i) if is_var else rp.C(i)
                                           for is_var, i in pat))
                        for pat in pats), n_vars=n_vars)


def _outcome(tbl, stats, as_numpy):
    rows = as_numpy(tbl)
    return (rows.dtype, rows.shape, rows.tobytes(),
            tuple(int(x) for x in stats)[:6], bool(tbl.overflow))


def _port_outcome(eng, q):
    return _outcome(*eng.run(q), results_as_numpy)


# --------------------------------------------------------------------------
# store-level delta semantics (twins of test_live_ingest.py)
# --------------------------------------------------------------------------

def test_apply_delta_set_semantics(store):
    ms, mp, mo = store.merged_triples()
    logical = set(zip(mp.tolist(), ms.tolist(), mo.tolist()))
    n0 = store.n_triples
    e0 = store.epoch

    # deleting a live triple tombstones it; the logical count drops
    t = next(iter(logical))
    store.apply_delta(delete=([t[1]], [t[0]], [t[2]]))
    assert store.n_triples == n0 - 1 and store.epoch == e0 + 1

    # re-inserting cancels the tombstone (no net change vs the base)
    store.apply_delta(insert=([t[1]], [t[0]], [t[2]]))
    assert store.n_triples == n0 and store.delta_size == 0

    # inserting a fresh triple, then deleting it, removes the insert
    fresh = (0, N_TERMS - 1, N_TERMS - 1)
    assert fresh not in logical
    store.apply_delta(insert=([fresh[1]], [fresh[0]], [fresh[2]]))
    assert store.n_triples == n0 + 1
    store.apply_delta(delete=([fresh[1]], [fresh[0]], [fresh[2]]))
    assert store.n_triples == n0 and store.delta_size == 0

    # ineffective batches do not bump the epoch
    e = store.epoch
    assert store.apply_delta(delete=([fresh[1]], [fresh[0]], [fresh[2]])) == e
    assert store.apply_delta(insert=([t[1]], [t[0]], [t[2]])) == e

    # out-of-dictionary ids are a rebuild, not a delta, and the batch
    # raises before anything of it applies
    with pytest.raises(ValueError, match="fixed dictionary"):
        store.apply_delta(insert=([0], [N_PREDS], [0]),
                          delete=([t[1]], [t[0]], [t[2]]))
    assert store.epoch == e and store.n_triples == n0
    with pytest.raises(ValueError, match="align"):
        store.apply_delta(insert=([0, 1], [0], [0]))


def test_merged_triples_match_manual_set(store):
    rng = np.random.default_rng(5)
    expect = set(zip(*[a.tolist() for a in store.merged_triples()]))
    for _ in range(3):
        ms, mp, mo = store.merged_triples()
        idx = rng.choice(ms.shape[0], 20, replace=False)
        ins = _triples(rng, 30)
        store.apply_delta(insert=ins, delete=(ms[idx], mp[idx], mo[idx]))
        expect -= set(zip(ms[idx].tolist(), mp[idx].tolist(),
                          mo[idx].tolist()))
        expect |= set(zip(*[np.asarray(a).tolist() for a in ins]))
        got = set(zip(*[a.tolist() for a in store.merged_triples()]))
        assert got == expect
        assert store.n_triples == len(expect)


def test_compaction_bit_identical_to_rebuild(store):
    rng = np.random.default_rng(6)
    store.apply_delta(**_round(rng, store.merged_triples()))
    store.apply_delta(**_round(rng, store.merged_triples()))
    ref = _rebuilt(store)
    assert store.delta_size > 0
    base_epoch, epoch = store.base_epoch, store.epoch
    assert store.compact() == epoch + 1
    assert store.delta_size == 0 and store.base_epoch == base_epoch + 1
    for name in HOST_FIELDS:
        assert np.array_equal(getattr(store, name), getattr(ref, name)), name
    for name in DELTA_FIELDS:
        assert getattr(store, name).shape == (0,), name
    assert store.n_triples == store.n_base == ref.n_triples
    # compaction changes no logical triple, and an empty delta is a no-op
    assert store.changed_preds_since(epoch) == frozenset()
    assert store.compact() == epoch + 1


def test_maybe_compact_threshold(store):
    rng = np.random.default_rng(12)
    store.apply_delta(**_round(rng, store.merged_triples(), 10, 10))
    assert not store.maybe_compact(frac=0.5)
    assert store.delta_size > 0
    assert store.maybe_compact(frac=0.0, floor=store.delta_size)
    assert store.delta_size == 0 and not store.maybe_compact(frac=0.0)


def test_changed_preds_tracking(store):
    e0 = store.epoch
    store.apply_delta(insert=([3], [1], [5]))
    store.apply_delta(insert=([4], [2], [6]))
    assert store.changed_preds_since(e0) == frozenset({1, 2})
    assert store.changed_preds_since(e0 + 1) == frozenset({2})
    assert store.changed_preds_since(store.epoch) == frozenset()
    assert store.changed_preds_since(store.epoch + 1) is None
    # a legacy bump has no attribution: callers must sweep everything
    store.bump_epoch()
    assert store.changed_preds_since(e0) is None


def test_device_view_keeps_the_base_resident(store):
    """Delta epochs re-upload only the ten delta tensors, at their exact
    lengths; compaction and ``bump_epoch`` re-upload the base."""
    dev0 = store.device_arrays("cpu")
    rng = np.random.default_rng(13)
    for _ in range(3):
        store.apply_delta(**_round(rng, store.merged_triples()))
        dev = store.device_arrays("cpu")
        assert dev is store.device_arrays("cpu")  # once per epoch
        for name in StoreArrays._fields[:6]:
            assert getattr(dev, name) is getattr(dev0, name), name
        for name, f in zip(StoreArrays._fields[6:], DELTA_FIELDS):
            assert np.array_equal(getattr(dev, name).numpy(),
                                  getattr(store, f)), name
        assert dev.ins_key_ps.shape[0] == len(store._ins_set)
        assert dev.tomb_pos_ps.shape[0] == len(store._tomb_set)
    store.compact()
    dev = store.device_arrays("cpu")
    assert dev.key_ps_pso is not dev0.key_ps_pso
    assert np.array_equal(dev.key_ps_pso.numpy(), store.h_key_ps)
    before = dev.s_pso
    store.bump_epoch()
    assert store.device_arrays("cpu").s_pso is not before


def test_degree_stats_reread_the_base_only_per_base_epoch(store,
                                                          monkeypatch):
    """The planner's base degrees are two segment reductions per *base*
    epoch; a delta epoch adds the insert maxima on the host and reads no
    base key."""
    from repro_torch.core import capacity

    calls = []
    real = capacity.kops.max_run_length_per_segment
    monkeypatch.setattr(capacity.kops, "max_run_length_per_segment",
                        lambda *a: calls.append(1) or real(*a))
    planner = capacity.CapacityPlanner(store, EngineConfig(), device="cpu")
    base_ps, base_po = (a.copy() for a in planner._degree_stats())
    assert len(calls) == 2
    rng = np.random.default_rng(14)
    for _ in range(2):
        store.apply_delta(**_round(rng, store.merged_triples()))
        max_ps, max_po = planner._degree_stats()
        ins_ps, ins_po = store.max_ins_degrees()
        assert np.array_equal(max_ps, base_ps + ins_ps)
        assert np.array_equal(max_po, base_po + ins_po)
        assert len(calls) == 2
    store.compact()
    planner._degree_stats()
    assert len(calls) == 4


def test_engine_sweeps_marks_on_every_new_epoch(store):
    """Nothing the engine or its planner caches outlives an epoch: the
    high-water marks of older epochs are swept on the first run at a new
    one, and the run reads the new epoch's view."""
    eng = QueryEngine(store, EngineConfig(cap=4), device="cpu")
    q = _queries()[2]
    eng.run(q)
    rng = np.random.default_rng(15)
    for _ in range(2):
        assert {k[3] for k in eng.planner._hwm} == {store.epoch}
        swept = eng.planner.stats.swept
        store.apply_delta(**_round(rng, store.merged_triples()))
        want = _port_outcome(QueryEngine(_rebuilt(store), EngineConfig(cap=4),
                                         device="cpu"), q)
        assert _port_outcome(eng, q) == want
        assert eng.planner.stats.swept > swept
    assert {k[3] for k in eng.planner._hwm} == {store.epoch}


# --------------------------------------------------------------------------
# the port's store against the reference's, write by write
# --------------------------------------------------------------------------

def _assert_same_store(ref, mine, e_lo=0):
    for f in HOST_FIELDS + DELTA_FIELDS:
        a, b = getattr(ref, f), getattr(mine, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    for f in ("n_triples", "n_base", "epoch", "base_epoch", "delta_size"):
        assert getattr(ref, f) == getattr(mine, f), f
    assert ref._ins_set == mine._ins_set and ref._tomb_set == mine._tomb_set
    for e in range(e_lo, mine.epoch + 2):
        assert ref.changed_preds_since(e) == mine.changed_preds_since(e), e
    for a, b in zip(ref.merged_triples(), mine.merged_triples()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(ref.max_ins_degrees(), mine.max_ins_degrees()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    ms, mp, mo = ref.merged_triples()
    rng = np.random.default_rng(mine.epoch)
    pick = rng.choice(ms.shape[0], 40, replace=False)
    probes = [(int(mp[i]), int(ms[i]), int(mo[i])) for i in pick]
    probes += [(p, int(s), int(o)) for p in range(N_PREDS)
               for s, o in rng.integers(0, N_TERMS, (4, 2))]
    for p in range(N_PREDS):
        assert ref.tp_cardinality(p) == mine.tp_cardinality(p)
    for p, s, o in probes:
        assert ref.tp_cardinality(p, s=s) == mine.tp_cardinality(p, s=s)
        assert ref.tp_cardinality(p, o=o) == mine.tp_cardinality(p, o=o)
        assert ref.tp_cardinality(p, s=s, o=o) == \
            mine.tp_cardinality(p, s=s, o=o)


def test_store_state_matches_reference(pair):
    """The same seeded batches — random rounds, churn that resurrects
    tombstones and cancels inserts, an ineffective batch, compaction, a
    legacy bump — leave both packages' stores bit-equal."""
    ref, mine = pair
    rng = np.random.default_rng(21)
    _assert_same_store(ref, mine)
    last = None
    for _ in range(4):
        batch = _round(rng, mine.merged_triples())
        if last is not None:  # churn: undo half of the last batch
            batch = dict(
                insert=tuple(np.concatenate([a, b[:10]]) for a, b in
                             zip(batch["insert"], last["delete"])),
                delete=tuple(np.concatenate([a, b[:10]]) for a, b in
                             zip(batch["delete"], last["insert"])))
        assert ref.apply_delta(**batch) == mine.apply_delta(**batch)
        _assert_same_store(ref, mine)
        last = batch
    noop = dict(delete=([N_TERMS - 1], [0], [N_TERMS - 1]))
    if (0, N_TERMS - 1, N_TERMS - 1) not in mine._ins_set | set(
            zip(*[a.tolist() for a in mine.merged_triples()])):
        assert ref.apply_delta(**noop) == mine.apply_delta(**noop)
    _assert_same_store(ref, mine)
    assert ref.compact() == mine.compact()
    _assert_same_store(ref, mine)
    batch = _round(rng, mine.merged_triples())
    ref.apply_delta(**batch)
    mine.apply_delta(**batch)
    assert ref.bump_epoch() == mine.bump_epoch()
    _assert_same_store(ref, mine)


def test_from_host_arrays_carries_the_delta(pair):
    ref, mine = pair
    rng = np.random.default_rng(22)
    for _ in range(2):
        ref.apply_delta(**_round(rng, ref.merged_triples()))
    carried = port_store(ref)  # columns, sets and epoch counters
    _assert_same_store(ref, carried, e_lo=ref.epoch)
    assert carried.changed_preds_since(0) is None  # the log is not carried
    arrays = {f: getattr(ref, f) for f in HOST_FIELDS + DELTA_FIELDS}
    from_sets = TripleStore.from_host_arrays(
        {f: getattr(ref, f) for f in HOST_FIELDS}, N_TERMS, N_PREDS,
        inserts=ref._ins_set, tombstones=ref._tomb_set)
    for f in DELTA_FIELDS:
        assert np.array_equal(getattr(from_sets, f), getattr(ref, f)), f
    assert from_sets.n_triples == ref.n_triples
    with pytest.raises(ValueError, match="h_ins_o_pos does not match"):
        TripleStore.from_host_arrays(
            dict(arrays, h_ins_o_pos=arrays["h_ins_o_pos"][::-1].copy()),
            N_TERMS, N_PREDS, inserts=ref._ins_set,
            tombstones=ref._tomb_set)
    with pytest.raises(ValueError, match="does not match"):  # sets missing
        TripleStore.from_host_arrays(arrays, N_TERMS, N_PREDS)
    base = {f: arrays[f] for f in HOST_FIELDS}
    live = (int(ref.h_key_ps[0] // N_TERMS), int(ref.h_s_pso[0]),
            int(ref.h_o_pso[0]))
    with pytest.raises(ValueError, match="must not be a base triple"):
        TripleStore.from_host_arrays(base, N_TERMS, N_PREDS, inserts={live})
    absent = next(t for t in ((0, N_TERMS - 1, o) for o in range(N_TERMS))
                  if t not in set(zip(*[a.tolist() for a in
                                        (ref.h_key_ps // N_TERMS,
                                         ref.h_s_pso, ref.h_o_pso)])))
    with pytest.raises(ValueError, match="must be a base triple"):
        TripleStore.from_host_arrays(base, N_TERMS, N_PREDS,
                                     tombstones={absent})


# --------------------------------------------------------------------------
# byte identity against the rebuilt store: every interface, >= 3 epochs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("interface", INTERFACES)
@pytest.mark.parametrize("cap", [2048, 4])
def test_engine_byte_identity_across_epochs(store, interface, cap):
    """Rows, overflow and the six gross stats of every query equal those
    of the same query against a ``build`` of the merged triple set, over
    three delta epochs and after compaction (``cap=4`` makes the ladder
    and the planner regrow)."""
    rng = np.random.default_rng(7)
    cfg = EngineConfig(interface=interface, cap=cap)
    qs = _queries()
    eng = QueryEngine(store, cfg, device="cpu")  # one engine across epochs
    for ep in range(3):
        store.apply_delta(**_round(rng, store.merged_triples()))
        ref_eng = QueryEngine(_rebuilt(store), cfg, device="cpu")
        for i, q in enumerate(qs):
            assert _port_outcome(eng, q) == _port_outcome(ref_eng, q), \
                (ep, i)
    store.compact()
    ref_eng = QueryEngine(_rebuilt(store), cfg, device="cpu")
    for i, q in enumerate(qs):
        assert _port_outcome(eng, q) == _port_outcome(ref_eng, q), i


# --------------------------------------------------------------------------
# edge deltas, against the reference and the rebuilt store
# --------------------------------------------------------------------------

def _edge_batch(case, ref):
    """A write batch for one edge case of the overlay, on ``ref``'s base.
    Predicate 7 has no base triples (the fixture leaves it empty)."""
    ms, mp, mo = ref.merged_triples()
    if case == "inserts_only":
        return dict(insert=([1, 2, 3, 50], [1, 1, 2, 3], [5, 6, 7, 9]))
    if case == "tombstones_only":
        hit = np.nonzero(mp == 1)[0][::3]
        return dict(delete=(ms[hit], mp[hit], mo[hit]))
    if case == "whole_run_deleted":
        s0 = int(ms[np.nonzero(mp == 1)[0][0]])
        run = np.nonzero((mp == 1) & (ms == s0))[0]
        more = np.nonzero((mp == 3) & (mo == mo[np.nonzero(mp == 3)[0][0]]))
        run = np.concatenate([run, more[0]])
        return dict(delete=(ms[run], mp[run], mo[run]))
    if case == "insert_into_empty_run":
        present = set(ms[mp == 1].tolist())
        fresh = [s for s in range(N_TERMS) if s not in present][:3]
        return dict(insert=(fresh + fresh, [1] * 6,
                            [0, 1, 2, N_TERMS - 1, 3, 7]))
    if case == "empty_base_predicate":
        return dict(insert=([1, 1, 2, 9, 9], [7] * 5, [3, 7, 3, 3, 1]))
    raise ValueError(case)


EDGE_CASES = ("inserts_only", "tombstones_only", "whole_run_deleted",
              "insert_into_empty_run", "empty_base_predicate")


@pytest.mark.parametrize("case", EDGE_CASES)
def test_edge_deltas_match_reference(case):
    rng = np.random.default_rng(31)
    s, p, o = _triples(rng, 900, n_preds=7)  # predicate 7 stays empty
    ref = RefStore.build(s, p, o, n_terms=N_TERMS, n_predicates=N_PREDS)
    mine = TripleStore.build(s, p, o, n_terms=N_TERMS, n_predicates=N_PREDS)
    batch = _edge_batch(case, ref)
    ref.apply_delta(**batch)
    mine.apply_delta(**batch)
    _assert_same_store(ref, mine)
    if case == "inserts_only":
        assert mine.h_tomb_pos_ps.shape == (0,) and len(mine._ins_set)
    if case == "tombstones_only":
        assert mine.h_ins_key_ps.shape == (0,) and len(mine._tomb_set)
    qs = _queries() + [
        BGP((TriplePattern(V(0), C(7), V(1)),), n_vars=2),
        BGP((TriplePattern(V(0), C(7), C(3)),
             TriplePattern(V(0), C(1), V(1))), n_vars=2),
        BGP((TriplePattern(C(1), C(1), V(0)),
             TriplePattern(V(1), C(7), V(0))), n_vars=2)]
    rebuilt = _rebuilt(mine)
    for interface in ("tpf", "spf"):
        cfg = dict(interface=interface, cap=2048)
        ref_eng = rc.QueryEngine(ref, rc.EngineConfig(**cfg))
        eng = QueryEngine(mine, EngineConfig(**cfg), device="cpu")
        reb = QueryEngine(rebuilt, EngineConfig(**cfg), device="cpu")
        for i, q in enumerate(qs):
            want = _outcome(*ref_eng.run(_ref_bgp(q)), rc.results_as_numpy)
            got = _port_outcome(eng, q)
            assert got == want, (interface, i)
            assert got == _port_outcome(reb, q), (interface, i)


# --------------------------------------------------------------------------
# WatDiv loads under seeded write windows, against the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def live_world(watdiv_small):
    """A private copy of the scale-10 WatDiv store in both packages, with
    three seeded write windows (``rdf.writes.WriteFeed``, 3% each, half on
    the loads' predicates) applied to both."""
    g, base = watdiv_small
    ref = RefStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                         n_predicates=g.n_predicates)
    mine = TripleStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                             n_predicates=g.n_predicates)
    loads = {load: generate_query_load(g, base, load,
                                       QueryLoadConfig(n_queries=2))
             for load in LOADS}
    read_preds = {t.p.id for qs in loads.values() for q in qs
                  for t in q.patterns if not t.p.is_var}
    before = {load: [_port_outcome(QueryEngine(
        mine, EngineConfig(interface="spf"), device="cpu"), port_bgp(q))
        for q in qs] for load, qs in loads.items()}
    feed = WriteFeed(mine, read_preds, rate=0.03, seed=3)
    for _ in range(3):
        window = feed.next_window()
        ref.apply_delta(**window)
        mine.apply_delta(**window)
    _assert_same_store(ref, mine)
    assert len(ref._ins_set) and len(ref._tomb_set)
    return g, ref, mine, loads, before


_REF_RUNS: dict = {}


def _ref_outcomes(ref_store, qs, **cfg):
    key = (tuple(sorted(cfg.items())), tuple(map(id, qs)))
    if key not in _REF_RUNS:
        eng = rc.QueryEngine(ref_store, rc.EngineConfig(**cfg))
        _REF_RUNS[key] = (eng, [_outcome(*eng.run(q), rc.results_as_numpy)
                                for q in qs])
    return _REF_RUNS[key]


def test_write_windows_change_answers(live_world):
    """The windows land on the read path: some load query answers
    differently after them than on the base store."""
    _, _, mine, loads, before = live_world
    eng = QueryEngine(mine, EngineConfig(interface="spf"), device="cpu")
    changed = sum(_port_outcome(eng, port_bgp(q))[2] != before[load][i][2]
                  for load, qs in loads.items() for i, q in enumerate(qs))
    assert changed > 0


def test_write_feed_mix(watdiv_small):
    """Window sizes, the read/feed split, churn, and determinism."""
    g, _ = watdiv_small
    stores = [TripleStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                                n_predicates=g.n_predicates)
              for _ in range(2)]
    read = {int(np.bincount(g.p).argmax())}
    feeds = [WriteFeed(s, read, rate=0.02, seed=9)
             for s in stores]
    assert read.isdisjoint(feeds[0].feed_preds.tolist())
    assert feeds[0].feed_preds.shape == (2,)
    prev = None
    for _ in range(2):
        n = stores[0].n_triples
        w0, w1 = (f.next_window() for f in feeds)
        for k in ("insert", "delete"):
            for a, b in zip(w0[k], w1[k]):
                assert np.array_equal(a, b)  # same seed, same windows
        n_ins, n_del = w0["insert"][0].shape[0], w0["delete"][0].shape[0]
        assert n_ins + n_del == round(0.02 * n)
        on_read = np.isin(w0["delete"][1], list(read)).mean()
        assert 0.4 <= on_read <= 0.6
        allowed = list(read) + feeds[0].feed_preds.tolist()
        assert np.isin(w0["insert"][1], allowed).all()
        if prev is not None:  # churn re-inserts the last window's deletes
            last_del = set(zip(*[a.tolist() for a in prev["delete"]]))
            now_ins = set(zip(*[a.tolist() for a in w0["insert"]]))
            assert len(last_del & now_ins) >= int(0.05 * n * 0.02) - 1
        for s in stores:
            s.apply_delta(**w0)
        prev = w0
    # every predicate read: the whole window goes to the read predicates
    everything = WriteFeed(stores[0], range(g.n_predicates), rate=0.02,
                           seed=9)
    assert everything.feed_preds.shape == (0,)
    w = everything.next_window()
    assert w["insert"][0].shape[0] + w["delete"][0].shape[0] == \
        round(0.02 * stores[0].n_triples)


@pytest.mark.parametrize("interface", INTERFACES)
@pytest.mark.parametrize("planner", [True, False])
def test_live_run_matches_reference(live_world, interface, planner):
    """One query of each WatDiv load through ``QueryEngine.run`` on the
    CPU against the reference's on the same delta state: rows, overflow
    and the six gross stats."""
    _, ref, mine, loads, _ = live_world
    qs = [loads[load][0] for load in LOADS]
    _, want = _ref_outcomes(ref, qs, interface=interface, cap=2048,
                            capacity_planner=planner)
    eng = QueryEngine(mine, EngineConfig(interface=interface, cap=2048,
                                         capacity_planner=planner),
                      device="cpu")
    for i, q in enumerate(qs):
        assert _port_outcome(eng, port_bgp(q)) == want[i], (LOADS[i])


@pytest.mark.parametrize("planner", [True, False])
def test_live_forced_overflow_matches_reference(live_world, planner):
    """A tiny starting capacity under the delta: the blind ladder climbs,
    the planner starts at oracle capacities (base + insert degrees), and
    a small high-water mark forces resume at the overflowed unit."""
    _, ref, mine, loads, _ = live_world
    qs = loads["2-stars"]
    _, want = _ref_outcomes(ref, qs, interface="spf", cap=4)
    eng = QueryEngine(mine, EngineConfig(interface="spf", cap=4,
                                         capacity_planner=planner),
                      device="cpu")
    for i, q in enumerate(qs):
        pq = port_bgp(q)
        if planner:
            plan = eng.plan(pq)
            for k in range(len(plan.units)):
                eng.planner.observe_unit(plan, k, 4)
        assert _port_outcome(eng, pq) == want[i]


def test_live_max_cap_latch_matches_reference(live_world):
    _, ref, mine, loads, _ = live_world
    qs = loads["2-stars"] + loads["3-stars"]
    _, want = _ref_outcomes(ref, qs, interface="spf", cap=4, max_cap=16)
    assert any(w[4] for w in want)  # the latch case actually happened
    for planner in (True, False):
        eng = QueryEngine(mine, EngineConfig(interface="spf", cap=4,
                                             max_cap=16,
                                             capacity_planner=planner),
                          device="cpu")
        for i, q in enumerate(qs):
            assert _port_outcome(eng, port_bgp(q)) == want[i], (planner, i)


def test_live_degree_oracle_matches_reference(live_world):
    """The planner's degree statistics under the delta: base half per base
    epoch, plus the insert maxima per epoch — equal to the reference's."""
    _, ref, mine, loads, _ = live_world
    r_plan = rc.CapacityPlanner(ref, rc.EngineConfig())
    p_plan = engine.CapacityPlanner(mine, EngineConfig(), device="cpu")
    for a, b in zip(r_plan._degree_stats(), p_plan._degree_stats()):
        assert np.array_equal(a, b)
    qs = [port_bgp(q) for qs in loads.values() for q in qs]
    for q, rq in zip(qs, [q for qs in loads.values() for q in qs]):
        plan = engine.plan_query(mine, q, EngineConfig())
        r_pl = rc.engine.plan_query(ref, rq, rc.EngineConfig())
        assert p_plan.unit_bounds(plan) == r_plan.unit_bounds(r_pl)


@pytest.mark.parametrize("load", LOADS)
def test_live_eval_unit_matches_reference(live_world, load):
    """Every unit of every plan seeded with the same table gives the same
    rows (invalid slots included), valid mask, overflow, ops and peak as
    the reference's — with the port's exact-length delta columns, and
    with the reference's own padded columns carried across as numpy (the
    padding is invisible either way).  A capacity of 64 makes some units
    overflow."""
    _, ref, mine, loads, _ = live_world
    ref_dev = ref.device
    assert ref_dev.ins_key_ps.shape[0] > mine.h_ins_key_ps.shape[0]  # padded
    padded = StoreArrays(*(torch.from_numpy(np.array(a)) for a in ref_dev))
    exact = mine.device_arrays("cpu")
    logn = server.log_factor(mine.n_triples)
    for interface in ("spf", "tpf"):
        for q in loads[load]:
            plan = engine.plan_query(mine, port_bgp(q),
                                     EngineConfig(interface=interface))
            r_plan = rc.engine.plan_query(ref, q,
                                          rc.EngineConfig(interface=interface))
            n_vars = max(plan.n_vars, 1)
            r_consts = jnp.asarray(np.asarray(plan.consts, np.int64))
            consts = torch.tensor(plan.consts, dtype=torch.int64)
            r_tbl = ref_bindings.unit_table(64, n_vars)
            for k, (up, r_up) in enumerate(zip(plan.units, r_plan.units)):
                w_tbl, w_ops, w_peak = ref_server.eval_unit(
                    ref_dev, ref.radix, r_up, r_consts, r_tbl, logn=logn)
                for dev in (exact, padded):
                    seed = bindings.BindingTable(
                        torch.from_numpy(np.array(r_tbl.rows)),
                        torch.from_numpy(np.array(r_tbl.valid)),
                        torch.tensor(bool(r_tbl.overflow)))
                    g_tbl, g_ops, g_peak = server.eval_unit(
                        dev, mine.radix, up, consts, seed, logn=logn)
                    ctx = (load, interface, k, dev is padded)
                    np.testing.assert_array_equal(
                        g_tbl.rows.numpy(), np.asarray(w_tbl.rows), str(ctx))
                    np.testing.assert_array_equal(g_tbl.valid.numpy(),
                                                  np.asarray(w_tbl.valid))
                    assert bool(g_tbl.overflow) == bool(w_tbl.overflow), ctx
                    assert int(g_ops) == int(w_ops), ctx
                    assert int(g_peak) == int(w_peak), ctx
                r_tbl = w_tbl
