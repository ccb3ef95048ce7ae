"""The port's host modules against the JAX package's: WatDiv generator,
query loads, pattern algebra and brute-force oracle — identical outputs
from the same seeds (exact)."""

import numpy as np
import pytest

from _torch import bgp_tuples, port_bgp

from repro.core import oracle as ref_oracle
from repro.core import patterns as ref_patterns
from repro.rdf import queries as ref_queries
from repro.rdf import watdiv as ref_watdiv
from repro_torch.core import oracle, patterns
from repro_torch.rdf import queries, watdiv
from repro_torch.rdf.store import TripleStore

LOADS = queries.QUERY_LOADS


@pytest.mark.parametrize("scale,seed", [(10, 7), (25, 3)])
def test_watdiv_identical(scale, seed):
    a = ref_watdiv.generate_watdiv(ref_watdiv.WatDivConfig(scale=scale,
                                                           seed=seed))
    b = watdiv.generate_watdiv(watdiv.WatDivConfig(scale=scale, seed=seed))
    for f in ("s", "p", "o"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("n_terms", "n_predicates", "class_ranges", "attr_preds",
              "rel_preds"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.fixture(scope="module")
def both_graphs(watdiv_small):
    g, ref_store = watdiv_small
    pg = watdiv.generate_watdiv(watdiv.WatDivConfig(scale=10))
    store = TripleStore.build(pg.s, pg.p, pg.o, n_terms=pg.n_terms,
                              n_predicates=pg.n_predicates)
    return g, ref_store, pg, store


@pytest.mark.parametrize("load", LOADS)
def test_query_loads_identical(both_graphs, load):
    g, ref_store, pg, store = both_graphs
    cfg = dict(n_queries=6, seed=13)
    ref_qs = ref_queries.generate_query_load(
        g, ref_store, load, ref_queries.QueryLoadConfig(**cfg))
    qs = queries.generate_query_load(pg, store, load,
                                     queries.QueryLoadConfig(**cfg))
    assert len(qs) == len(ref_qs) == 6
    assert [bgp_tuples(q) for q in qs] == [bgp_tuples(q) for q in ref_qs]
    for q, rq in zip(qs, ref_qs):
        assert patterns.count_stars(q) == ref_patterns.count_stars(rq)
        mine = [(bgp_tuples(patterns.BGP(s.triple_patterns, q.n_vars)))
                for s in patterns.star_decomposition(q)]
        theirs = [(bgp_tuples(ref_patterns.BGP(s.triple_patterns, rq.n_vars)))
                  for s in ref_patterns.star_decomposition(rq)]
        assert mine == theirs


def test_unknown_load_rejected(both_graphs):
    _, _, pg, store = both_graphs
    with pytest.raises(ValueError, match="unknown query load"):
        queries.generate_query_load(pg, store, "4-stars")


def test_bgp_tuple_roundtrip(both_graphs):
    g, ref_store, _, _ = both_graphs
    for load in LOADS:
        for rq in ref_queries.generate_query_load(
                g, ref_store, load, ref_queries.QueryLoadConfig(n_queries=3)):
            q = patterns.bgp_from_tuples(*bgp_tuples(rq))
            assert bgp_tuples(q) == bgp_tuples(rq)
            assert q.variables() == rq.variables() and len(q) == len(rq)
            assert patterns.bgp_from_tuples(*bgp_tuples(q)) == q


def test_oracle_identical(both_graphs):
    g, ref_store, _, _ = both_graphs
    for load in LOADS:
        for rq in ref_queries.generate_query_load(
                g, ref_store, load, ref_queries.QueryLoadConfig(n_queries=2)):
            want = ref_oracle.eval_bgp_bruteforce(g.s, g.p, g.o, rq)
            got = oracle.eval_bgp_bruteforce(g.s, g.p, g.o, port_bgp(rq))
            assert got == want and got
    rows = np.array([[1, -1], [2, 3]], np.int32)
    assert oracle.table_to_solution_set(rows) == \
        ref_oracle.table_to_solution_set(rows)
