"""WatDiv-like synthetic knowledge-graph generator.

WatDiv (Aluc et al., ISWC 2014) generates an e-commerce-flavoured RDF graph:
entity classes (User, Product, Review, Retailer, ...) with per-class
*attribute* predicates (functional or low-fanout -> star-shaped data) and
*relation* predicates linking classes (-> path-shaped data), with Zipfian
value and fanout distributions ("diversified stress testing").

This module reproduces that structure parametrically: ``scale`` controls
entity counts; attribute values are Zipf-distributed; relations have
power-law out-degree.  The paper uses a 10M-triple WatDiv instance.  The
generator is linear in ``scale`` at about 488 unique triples per unit of
scale: ``scale=20_500`` gives the paper's size, 10,018,031 unique triples
(generated and deduplicated in about 21 s on one host core), while
``scale=85_000`` gives 41,526,598.  Tests use ``scale=10``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class EntityClass:
    name: str
    count: int
    n_attributes: int
    # relations: (target class index, avg out-degree)
    relations: tuple[tuple[int, float], ...] = ()


@dataclass
class WatDivConfig:
    scale: int = 1000  # baseline entity count multiplier
    n_attr_values: int = 1000  # distinct literal pool per attribute
    zipf_a: float = 1.6  # attribute-value skew
    seed: int = 7
    # class table roughly mirroring WatDiv's schema proportions
    classes: tuple[EntityClass, ...] = field(default_factory=lambda: (
        EntityClass("User", 10, 5, ((2, 1.5), (1, 2.0))),       # follows Product? no: likes Product, makesReview
        EntityClass("Product", 25, 9, ((3, 1.0),)),              # hasRetailer
        EntityClass("Review", 30, 4, ((1, 1.0), (0, 1.0))),      # reviews Product, writtenBy User
        EntityClass("Retailer", 1, 6, ()),
        EntityClass("Website", 5, 3, ((1, 3.0),)),               # offers Product
    ))


@dataclass
class WatDivGraph:
    """Generated graph + schema metadata needed by the query generator."""

    s: np.ndarray
    p: np.ndarray
    o: np.ndarray
    n_terms: int
    n_predicates: int
    # schema maps
    class_ranges: list[tuple[int, int]]  # entity-id range per class
    attr_preds: list[list[int]]  # predicate ids per class (attributes)
    rel_preds: list[list[tuple[int, int]]]  # (pred id, target class) per class


def generate_watdiv(cfg: WatDivConfig) -> WatDivGraph:
    rng = np.random.default_rng(cfg.seed)
    classes = cfg.classes

    # ---------------------------------------------------------- id layout
    # entity ids first, then attribute-value literal ids
    class_ranges: list[tuple[int, int]] = []
    next_id = 0
    for c in classes:
        n = c.count * cfg.scale
        class_ranges.append((next_id, next_id + n))
        next_id += n
    lit_base = next_id

    # predicates: class attribute predicates, then relation predicates
    attr_preds: list[list[int]] = []
    rel_preds: list[list[tuple[int, int]]] = []
    next_pred = 0
    for c in classes:
        attr_preds.append(list(range(next_pred, next_pred + c.n_attributes)))
        next_pred += c.n_attributes
    for ci, c in enumerate(classes):
        rp = []
        for tgt, _deg in c.relations:
            rp.append((next_pred, tgt))
            next_pred += 1
        rel_preds.append(rp)

    # literal pool: one pool per attribute predicate
    n_lits_total = next_pred * cfg.n_attr_values  # upper bound; only attr preds used
    n_terms = lit_base + n_lits_total

    ss: list[np.ndarray] = []
    ps: list[np.ndarray] = []
    os_: list[np.ndarray] = []

    # ------------------------------------------------------- attribute triples
    for ci, c in enumerate(classes):
        lo, hi = class_ranges[ci]
        ents = np.arange(lo, hi, dtype=np.int64)
        for a_i, pid in enumerate(attr_preds[ci]):
            # ~85% of entities carry each attribute (WatDiv attributes are
            # not universal, which is what gives stars varying cardinality)
            mask = rng.random(ents.shape[0]) < 0.85
            subj = ents[mask]
            vals = rng.zipf(cfg.zipf_a, size=subj.shape[0])
            vals = np.minimum(vals, cfg.n_attr_values) - 1
            obj = lit_base + pid * cfg.n_attr_values + vals
            ss.append(subj)
            ps.append(np.full(subj.shape[0], pid, np.int64))
            os_.append(obj.astype(np.int64))

    # -------------------------------------------------------- relation triples
    for ci, c in enumerate(classes):
        lo, hi = class_ranges[ci]
        ents = np.arange(lo, hi, dtype=np.int64)
        for (pid, tgt), (_, deg) in zip(rel_preds[ci], c.relations):
            t_lo, t_hi = class_ranges[tgt]
            # power-law out-degree, mean ~= deg
            degs = np.minimum(rng.geometric(1.0 / max(deg, 1e-6), ents.shape[0]), 40)
            subj = np.repeat(ents, degs)
            obj = rng.integers(t_lo, t_hi, size=subj.shape[0], dtype=np.int64)
            ss.append(subj)
            ps.append(np.full(subj.shape[0], pid, np.int64))
            os_.append(obj)

    s = np.concatenate(ss)
    p = np.concatenate(ps)
    o = np.concatenate(os_)
    return WatDivGraph(
        s=s, p=p, o=o,
        n_terms=n_terms,
        n_predicates=next_pred,
        class_ranges=class_ranges,
        attr_preds=attr_preds,
        rel_preds=rel_preds,
    )
