"""Query-load generator: the paper's 1-star / 2-stars / 3-stars / paths loads.

Section 6 of the paper: 50 queries per load per client; 1/2/3-star loads have
that many (non-trivial) star patterns; the *paths* load is chains of
object-subject joins (zero stars); *union* is the mix of all four.  Every
query is guaranteed >= 1 answer — we enforce that the same way a benchmark
generator must: sample a witness (an actual subgraph) from the data and
generalise it into a pattern, keeping some constants for selectivity.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from repro_torch.core.patterns import BGP, C, Term, TriplePattern, V
from repro_torch.rdf.watdiv import WatDivGraph


@dataclass
class QueryLoadConfig:
    n_queries: int = 50
    seed: int = 13
    # star size range (triple patterns per star); paper's Fig. 4b shows 2-8
    min_branches: int = 2
    max_branches: int = 5
    # path length range; paper: mean 6.89, max 9
    min_path: int = 3
    max_path: int = 9
    # fraction of object terms kept constant (selectivity knob)
    const_object_frac: float = 0.3


def _witness_star(rng, g: WatDivGraph, store, ci: int, subj: int,
                  n_branches: int, subj_var: int, next_var: int,
                  const_frac: float) -> tuple[list[TriplePattern], int]:
    """Build a star rooted at variable ``subj_var`` generalising entity
    ``subj`` of class ``ci``; returns (patterns, next free var)."""
    preds = [pid for pid in g.attr_preds[ci] if store.tp_cardinality(pid, s=subj) > 0]
    rng.shuffle(preds)
    preds = preds[:n_branches]
    patterns: list[TriplePattern] = []
    for pid in preds:
        lo, hi = store.ps_run(pid, subj)
        obj = int(store.h_o_pso[lo + rng.integers(0, hi - lo)])
        if rng.random() < const_frac:
            o_term: Term = C(obj)
        else:
            o_term = V(next_var)
            next_var += 1
        patterns.append(TriplePattern(V(subj_var), C(pid), o_term))
    return patterns, next_var


def _pick_linked_entity(rng, g: WatDivGraph, store, ci: int, subj: int
                        ) -> tuple[int, int, int] | None:
    """Pick a relation predicate from class ``ci`` with a witness edge from
    ``subj``; returns (pred id, target class, target entity) or None."""
    rels = list(g.rel_preds[ci])
    rng.shuffle(rels)
    for pid, tgt in rels:
        lo, hi = store.ps_run(pid, subj)
        if hi > lo:
            obj = int(store.h_o_pso[lo + rng.integers(0, hi - lo)])
            return pid, tgt, obj
    return None


def _gen_star_query(rng, g: WatDivGraph, store, n_stars: int,
                    cfg: QueryLoadConfig) -> BGP | None:
    """A chain of ``n_stars`` stars linked by relation predicates."""
    # start from a class that has relations if n_stars > 1
    candidates = [ci for ci in range(len(g.class_ranges))
                  if n_stars == 1 or g.rel_preds[ci]]
    ci = int(rng.choice(candidates))
    lo, hi = g.class_ranges[ci]
    subj = int(rng.integers(lo, hi))
    patterns: list[TriplePattern] = []
    next_var = 0
    subj_var = next_var
    next_var += 1
    for k in range(n_stars):
        nb = int(rng.integers(cfg.min_branches, cfg.max_branches + 1))
        star, next_var = _witness_star(
            rng, g, store, ci, subj, nb, subj_var, next_var, cfg.const_object_frac)
        if len(star) < 2:
            return None
        patterns.extend(star)
        if k + 1 < n_stars:
            link = _pick_linked_entity(rng, g, store, ci, subj)
            if link is None:
                return None
            pid, tgt, obj = link
            nxt_var = next_var
            next_var += 1
            patterns.append(TriplePattern(V(subj_var), C(pid), V(nxt_var)))
            subj_var, ci, subj = nxt_var, tgt, obj
    return BGP(tuple(patterns), next_var)


def _gen_path_query(rng, g: WatDivGraph, store, cfg: QueryLoadConfig) -> BGP | None:
    """Chained object-subject joins, zero stars (paper footnote 8)."""
    length = int(rng.integers(cfg.min_path, cfg.max_path + 1))
    candidates = [ci for ci in range(len(g.class_ranges)) if g.rel_preds[ci]]
    ci = int(rng.choice(candidates))
    lo, hi = g.class_ranges[ci]
    subj = int(rng.integers(lo, hi))
    patterns: list[TriplePattern] = []
    next_var = 0
    cur_var = next_var
    next_var += 1
    for k in range(length):
        link = _pick_linked_entity(rng, g, store, ci, subj)
        if link is None:
            break
        pid, tgt, obj = link
        nxt = next_var
        next_var += 1
        patterns.append(TriplePattern(V(cur_var), C(pid), V(nxt)))
        cur_var, ci, subj = nxt, tgt, obj
        # relation chains in the schema can cycle (User->Review->User...)
    if len(patterns) < cfg.min_path:
        # close with one attribute hop to reach the minimum length
        attrs = [pid for pid in g.attr_preds[ci] if store.tp_cardinality(pid, s=subj) > 0]
        if attrs:
            pid = int(rng.choice(attrs))
            patterns.append(TriplePattern(V(cur_var), C(pid), V(next_var)))
            next_var += 1
    if len(patterns) < 2:
        return None
    return BGP(tuple(patterns), next_var)


# the paper's five query loads — the only names generate_query_load accepts
QUERY_LOADS = ("1-star", "2-stars", "3-stars", "paths", "union")


def generate_query_load(g: WatDivGraph, store, load: str,
                        cfg: QueryLoadConfig | None = None) -> list[BGP]:
    """Generate one of the paper's query loads.

    ``load`` in ``QUERY_LOADS``.
    """
    if load not in QUERY_LOADS:
        raise ValueError(f"unknown query load {load!r}; expected one of "
                         f"{QUERY_LOADS}")
    cfg = cfg or QueryLoadConfig()
    # deterministic per-load seed (Python's hash() is process-randomised)
    load_tag = zlib.crc32(load.encode()) % 1000
    rng = np.random.default_rng(cfg.seed + load_tag)
    out: list[BGP] = []
    kinds = {"1-star": 1, "2-stars": 2, "3-stars": 3}
    attempts = 0
    while len(out) < cfg.n_queries and attempts < cfg.n_queries * 50:
        attempts += 1
        if load == "union":
            sub = ["1-star", "2-stars", "3-stars", "paths"][len(out) % 4]
        else:
            sub = load
        if sub == "paths":
            q = _gen_path_query(rng, g, store, cfg)
        else:
            q = _gen_star_query(rng, g, store, kinds[sub], cfg)
        if q is not None:
            out.append(q)
    return out
