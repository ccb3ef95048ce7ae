"""Brute-force BGP evaluation oracle (pure numpy, exponential-ish, test-only).

Evaluates a BGP by naive backtracking over the raw triple list — no indexes,
no decomposition.  This is the ground truth every engine (and the
distributed runtime) is checked against: all four interfaces must return
exactly this solution set (the paper's engines differ in cost, never in
answers).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.patterns import BGP, TriplePattern


def eval_bgp_bruteforce(s: np.ndarray, p: np.ndarray, o: np.ndarray,
                        bgp: BGP) -> set[tuple[int, ...]]:
    """Return the set of solution mappings as tuples over vars 0..n_vars-1
    (-1 for variables not occurring in the query)."""
    triples = np.stack([np.asarray(s), np.asarray(p), np.asarray(o)], axis=1)
    triples = np.unique(triples, axis=0)
    n_vars = bgp.n_vars

    def match(tp: TriplePattern, binding: dict[int, int]) -> list[dict[int, int]]:
        mask = np.ones(triples.shape[0], dtype=bool)
        for pos, term in zip(range(3), (tp.s, tp.p, tp.o)):
            if term.is_var:
                if term.id in binding:
                    mask &= triples[:, pos] == binding[term.id]
            else:
                mask &= triples[:, pos] == term.id
        out = []
        for row in triples[mask]:
            b = dict(binding)
            ok = True
            for pos, term in zip(range(3), (tp.s, tp.p, tp.o)):
                if term.is_var:
                    if term.id in b and b[term.id] != int(row[pos]):
                        ok = False
                        break
                    b[term.id] = int(row[pos])
            if ok:
                out.append(b)
        return out

    solutions: list[dict[int, int]] = [{}]
    for tp in bgp.patterns:
        nxt: list[dict[int, int]] = []
        for b in solutions:
            nxt.extend(match(tp, b))
        solutions = nxt
        if not solutions:
            return set()
    return {tuple(b.get(v, -1) for v in range(n_vars)) for b in solutions}


def table_to_solution_set(rows: np.ndarray) -> set[tuple[int, ...]]:
    return {tuple(int(x) for x in r) for r in rows}
