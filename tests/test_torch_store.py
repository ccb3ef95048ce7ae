"""The port's triple store against the JAX package's: bit-equal host
index, the carried-over index, the torch device view, and twins of
``tests/test_store.py``'s base cases."""

import numpy as np
import pytest

from _hyp import given, settings, st
from _torch import HOST_FIELDS, port_store, torch

from repro.rdf.store import TripleStore as RefStore
from repro_torch.rdf import store as store_mod
from repro_torch.rdf.store import StoreArrays, TripleStore


@st.composite
def triple_sets(draw):
    n = draw(st.integers(1, 200))
    n_terms = draw(st.integers(5, 50))
    n_preds = draw(st.integers(1, 6))
    s = draw(st.lists(st.integers(0, n_terms - 1), min_size=n, max_size=n))
    p = draw(st.lists(st.integers(0, n_preds - 1), min_size=n, max_size=n))
    o = draw(st.lists(st.integers(0, n_terms - 1), min_size=n, max_size=n))
    return (np.array(s), np.array(p), np.array(o), n_terms, n_preds)


def _assert_same_index(a, b):
    assert (a.n_triples, a.n_terms, a.n_predicates) == \
        (b.n_triples, b.n_terms, b.n_predicates)
    for f in HOST_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert np.array_equal(x, y), f


def test_build_bit_equal(watdiv_small):
    g, ref_store = watdiv_small
    mine = TripleStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                             n_predicates=g.n_predicates)
    _assert_same_index(mine, ref_store)
    assert mine.radix == ref_store.radix and mine.epoch == ref_store.epoch


def test_from_host_arrays_roundtrip(watdiv_small):
    g, ref_store = watdiv_small
    carried = port_store(ref_store)
    _assert_same_index(carried, ref_store)
    rebuilt = TripleStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                                n_predicates=g.n_predicates)
    _assert_same_index(carried, rebuilt)
    # types are pinned on the way in
    loose = {f: getattr(ref_store, f).astype(np.int64) for f in HOST_FIELDS}
    _assert_same_index(TripleStore.from_host_arrays(
        loose, ref_store.n_terms, ref_store.n_predicates), ref_store)


def test_from_host_arrays_rejects_bad_shapes(watdiv_small):
    _, ref_store = watdiv_small
    arrays = {f: getattr(ref_store, f) for f in HOST_FIELDS}
    with pytest.raises(ValueError, match="same length"):
        TripleStore.from_host_arrays(dict(arrays, h_s_pso=arrays["h_s_pso"][1:]),
                                     ref_store.n_terms, ref_store.n_predicates)
    with pytest.raises(ValueError, match="n_predicates"):
        TripleStore.from_host_arrays(arrays, ref_store.n_terms,
                                     ref_store.n_predicates + 1)


def test_device_arrays_cpu(watdiv_small):
    _, ref_store = watdiv_small
    store = port_store(ref_store)
    dev = store.device_arrays("cpu")
    assert isinstance(dev, StoreArrays) and len(dev) == 16
    want = {"key_ps_pso": ref_store.h_key_ps, "s_pso": ref_store.h_s_pso,
            "o_pso": ref_store.h_o_pso, "key_po_pos": ref_store.h_key_po,
            "s_pos": ref_store.h_s_pos, "o_pos": ref_store.h_o_pos}
    for name, arr in want.items():
        t = getattr(dev, name)
        assert t.device.type == "cpu" and t.is_contiguous()
        assert t.numpy().dtype == arr.dtype
        assert np.array_equal(t.numpy(), arr)
    # the delta columns are the zero-length "no delta" view of the reference
    ref_dev = ref_store.device
    for name in StoreArrays._fields[6:]:
        t = getattr(dev, name)
        assert t.shape == (0,) == getattr(ref_dev, name).shape, name
        assert str(t.dtype).split(".")[-1] == str(getattr(ref_dev, name).dtype)
    assert store.device_arrays("cpu") is dev  # uploaded once per epoch


def test_device_defaults_to_card(watdiv_small, monkeypatch):
    _, ref_store = watdiv_small
    store = port_store(ref_store)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store.device_arrays()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        store_mod.resolve_device("cuda")
    assert store_mod.resolve_device("cpu") == torch.device("cpu")


def test_radix_overflow_rejected():
    with pytest.raises(ValueError, match="radix overflow"):
        TripleStore.build(np.array([0]), np.array([0]), np.array([0]),
                          n_terms=2**61, n_predicates=4)


@given(triple_sets())
@settings(max_examples=25, deadline=None)
def test_indexes_sorted_and_consistent(data):
    s, p, o, n_terms, n_preds = data
    store = TripleStore.build(s, p, o, n_terms=n_terms, n_predicates=n_preds)
    _assert_same_index(store, RefStore.build(s, p, o, n_terms=n_terms,
                                             n_predicates=n_preds))
    assert np.all(np.diff(store.h_key_ps) >= 0)
    assert np.all(np.diff(store.h_key_po) >= 0)
    uniq = len({(a, b, c) for a, b, c in zip(s, p, o)})
    assert store.n_triples == uniq
    p1 = store.h_key_ps // store.n_terms
    p2 = store.h_key_po // store.n_terms
    assert np.bincount(p1, minlength=n_preds).tolist() == \
        np.bincount(p2, minlength=n_preds).tolist()


@given(triple_sets())
@settings(max_examples=25, deadline=None)
def test_cardinality_matches_bruteforce(data):
    s, p, o, n_terms, n_preds = data
    store = TripleStore.build(s, p, o, n_terms=n_terms, n_predicates=n_preds)
    ref = RefStore.build(s, p, o, n_terms=n_terms, n_predicates=n_preds)
    triples = {(a, b, c) for a, b, c in zip(s.tolist(), p.tolist(),
                                            o.tolist())}
    rng = np.random.default_rng(0)
    for _ in range(10):
        pp = int(rng.integers(0, n_preds))
        ss = int(rng.integers(0, n_terms))
        oo = int(rng.integers(0, n_terms))
        assert store.tp_cardinality(pp) == sum(t[1] == pp for t in triples)
        assert store.tp_cardinality(pp, s=ss) == sum(
            t[0] == ss and t[1] == pp for t in triples)
        assert store.tp_cardinality(pp, o=oo) == sum(
            t[1] == pp and t[2] == oo for t in triples)
        assert store.tp_cardinality(pp, s=ss, o=oo) == int(
            (ss, pp, oo) in triples)
        assert store.pred_run(pp) == ref.pred_run(pp)
        assert store.ps_run(pp, ss) == ref.ps_run(pp, ss)
        assert store.po_run(pp, oo) == ref.po_run(pp, oo)


def test_runs_and_cardinalities_match_reference(watdiv_small):
    _, ref_store = watdiv_small
    store = port_store(ref_store)
    rng = np.random.default_rng(5)
    for _ in range(200):
        p = int(rng.integers(0, store.n_predicates))
        s = int(rng.choice(store.h_s_pso))
        o = int(rng.choice(store.h_o_pso))
        assert store.pred_run(p) == ref_store.pred_run(p)
        assert store.ps_run(p, s) == ref_store.ps_run(p, s)
        assert store.po_run(p, o) == ref_store.po_run(p, o)
        for kw in ({}, {"s": s}, {"o": o}, {"s": s, "o": o}):
            assert store.tp_cardinality(p, **kw) == \
                ref_store.tp_cardinality(p, **kw)
