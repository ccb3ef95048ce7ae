"""The port's triple store against the JAX package's: bit-equal host
index, the carried-over index, the torch device view, and twins of
``tests/test_store.py``'s base cases."""

import numpy as np
import pytest

from _hyp import given, settings, st
from _torch import HOST_FIELDS, port_store, torch

from repro.rdf.store import TripleStore as RefStore
from repro.rdf.store import _subject_hash as ref_subject_hash
from repro_torch.rdf import store as store_mod
from repro_torch.rdf.store import StoreArrays, TripleStore, _subject_hash


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


# --------------------------------------------------------------- sharding

@given(triple_sets(), st.integers(2, 8))
@settings(max_examples=15, deadline=None)
def test_subject_sharding_partitions(data, n_shards):
    """Twin of ``tests/test_store.py``'s: every real triple lands on the
    shard its subject hashes to, and the shards are padded to one length."""
    s, p, o, n_terms, n_preds = data
    store = TripleStore.build(s, p, o, n_terms=n_terms, n_predicates=n_preds)
    shards = store.shard_by_subject(n_shards)
    total_real = 0
    for i, sh in enumerate(shards):
        pred = sh.h_key_ps // sh.n_terms
        real = pred < n_preds  # padding uses predicate id n_preds
        subs = sh.h_s_pso[real].astype(np.int64)
        assert np.all(_subject_hash(subs) % n_shards == i)
        total_real += int(real.sum())
    assert total_real == store.n_triples
    assert len({sh.n_triples for sh in shards}) == 1


def test_subject_hash_matches_reference():
    rng = np.random.default_rng(3)
    ids = np.concatenate([
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 5000,
                     dtype=np.int64),
        np.array([0, 1, -1, 2**31 - 1, 2**32, np.iinfo(np.int64).min,
                  np.iinfo(np.int64).max], np.int64)])
    np.testing.assert_array_equal(_subject_hash(ids), ref_subject_hash(ids))
    assert [store_mod._owner(int(x), 7) for x in ids[:50]] == \
        (ref_subject_hash(ids[:50]) % 7).tolist()


def _stores(g):
    """A fresh reference store and the port's, built from one graph."""
    kw = dict(n_terms=g.n_terms, n_predicates=g.n_predicates)
    return (RefStore.build(g.s, g.p, g.o, **kw),
            TripleStore.build(g.s, g.p, g.o, **kw))


def _assert_same_shards(ref, mine, n_shards):
    for a, b in zip(ref.shard_by_subject(n_shards),
                    mine.shard_by_subject(n_shards), strict=True):
        _assert_same_index(a, b)
    want = ref.stacked_shard_arrays(n_shards)
    got = mine.stacked_shard_arrays(n_shards, "cpu")
    for name in StoreArrays._fields[:6]:
        w, t = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert t.dtype == w.dtype and t.shape == w.shape, name
        np.testing.assert_array_equal(t, w, err_msg=name)
    return want, got


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4])
def test_shards_and_stacked_base_match_reference(watdiv_small, n_shards):
    g, _ = watdiv_small
    ref, mine = _stores(g)
    _, got = _assert_same_shards(ref, mine, n_shards)
    assert got.key_ps_pso.shape[0] == n_shards
    for name in StoreArrays._fields[6:]:  # no delta: zero-length columns
        assert getattr(got, name).shape == (n_shards, 0), name
    assert mine.stacked_shard_arrays(n_shards, "cpu") is got
    with pytest.raises(ValueError, match="n_shards"):
        mine.shard_by_subject(0)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_shard_deltas_follow_writes(watdiv_small, n_shards):
    """After ``apply_delta`` each shard's delta columns equal the
    reference's on their valid prefix (the reference pads to a pow2
    bucket, the port to the largest shard's exact length, with the same
    values) and the cached base shards and base tensors stay; after
    ``compact`` the shard cache is rebuilt over the new base."""
    g, _ = watdiv_small
    ref, mine = _stores(g)
    _assert_same_shards(ref, mine, n_shards)
    shards = mine.shard_by_subject(n_shards)
    base = mine.stacked_shard_arrays(n_shards, "cpu")[:6]
    rng = np.random.default_rng(n_shards)
    k = rng.choice(ref.n_triples, 60, replace=False)
    dels = (ref.h_s_pso[k], ref.h_key_ps[k] // ref.n_terms, ref.h_o_pso[k])
    ins = tuple(rng.integers(0, hi, 50) for hi in
                (g.n_terms, g.n_predicates, g.n_terms))
    for st_ in (ref, mine):
        st_.apply_delta(insert=ins, delete=dels)
    assert mine.shard_by_subject(n_shards) is shards  # cached base kept
    want, got = _assert_same_shards(ref, mine, n_shards)
    for a, b in zip(base, got[:6]):
        assert a is b  # the base tensors are not re-uploaded
    for i, (rs, ms) in enumerate(zip(ref.shard_by_subject(n_shards),
                                     shards)):
        assert ms._ins_set == rs._ins_set and ms._tomb_set == rs._tomb_set
        assert ms.n_triples == rs.n_triples and ms.epoch == mine.epoch
        m, t = ms.h_ins_key_ps.shape[0], ms.h_tomb_pos_ps.shape[0]
        for j, name in enumerate(StoreArrays._fields[6:]):
            exact = m if j < 6 else t
            w = np.asarray(getattr(want, name))[i]
            col = getattr(got, name)[i].numpy()
            np.testing.assert_array_equal(col[:exact], w[:exact],
                                          err_msg=name)
            # the padding is the reference's padding, to the longest shard
            np.testing.assert_array_equal(col[exact:],
                                          w[exact:col.shape[0]],
                                          err_msg=name)
    longest = max(s.h_ins_key_ps.shape[0] for s in shards)
    assert got.ins_key_ps.shape == (n_shards, longest)
    assert longest > 0 and all(s.delta_size for s in shards)
    for st_ in (ref, mine):
        st_.compact()
    assert mine.shard_by_subject(n_shards) is not shards
    _, got = _assert_same_shards(ref, mine, n_shards)
    for name in StoreArrays._fields[6:]:
        assert getattr(got, name).shape == (n_shards, 0), name
