"""SPARQL pattern algebra: terms, triple patterns, BGPs, star decomposition.

Implements the paper's Definition 7 (star decomposition): a BGP is
partitioned into non-overlapping star patterns, one per distinct subject
term; every triple pattern belongs to exactly one star.  Following the
paper's footnote 8, a group counts as a *star* (for load classification)
only when it has >= 2 triple patterns; single-pattern groups degenerate to
plain triple patterns and SPF behaves exactly like brTPF on them.

Queries are host-side (static) structures: term ids are concrete Python
ints, so query *structure* is fixed per plan while binding *values* live
in device tensors.

``bgp_from_tuples`` builds a BGP from plain ``(is_var, id)`` tuples, so a
BGP written out by another implementation of this algebra can be
evaluated here unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator


@dataclass(frozen=True, order=True)
class Term:
    """A query term: variable (``is_var=True``, ``id`` = variable index) or
    constant (``id`` = dictionary id)."""

    is_var: bool
    id: int

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"?v{self.id}" if self.is_var else f":{self.id}"


def V(i: int) -> Term:
    return Term(True, i)


def C(i: int) -> Term:
    return Term(False, int(i))


@dataclass(frozen=True, order=True)
class TriplePattern:
    s: Term
    p: Term
    o: Term

    def variables(self) -> tuple[int, ...]:
        return tuple(t.id for t in (self.s, self.p, self.o) if t.is_var)

    def __repr__(self) -> str:  # pragma: no cover
        return f"({self.s} {self.p} {self.o})"


@dataclass(frozen=True)
class StarPattern:
    """A set of triple patterns sharing one subject term (Def. 7 clause ii).

    ``branches`` are (predicate, object) term pairs; the shared subject is
    kept once.  The simplest star has a single branch — it is then exactly a
    triple pattern, which is what makes SPF backwards compatible with
    TPF/brTPF (Section 4).
    """

    subject: Term
    branches: tuple[tuple[Term, Term], ...]

    @property
    def triple_patterns(self) -> tuple[TriplePattern, ...]:
        return tuple(TriplePattern(self.subject, p, o) for p, o in self.branches)

    def variables(self) -> tuple[int, ...]:
        out: list[int] = []
        if self.subject.is_var:
            out.append(self.subject.id)
        for p, o in self.branches:
            if p.is_var:
                out.append(p.id)
            if o.is_var:
                out.append(o.id)
        # stable de-dup
        seen: set[int] = set()
        uniq = []
        for v in out:
            if v not in seen:
                seen.add(v)
                uniq.append(v)
        return tuple(uniq)

    @property
    def is_trivial(self) -> bool:
        """True when the star has a single triple pattern (footnote 8)."""
        return len(self.branches) == 1

    def __repr__(self) -> str:  # pragma: no cover
        inner = " . ".join(f"{self.subject} {p} {o}" for p, o in self.branches)
        return f"Star{{{inner}}}"


@dataclass(frozen=True)
class BGP:
    """A basic graph pattern: a set of triple patterns over ``n_vars``
    variables numbered ``0 .. n_vars-1``."""

    patterns: tuple[TriplePattern, ...]
    n_vars: int

    def variables(self) -> tuple[int, ...]:
        seen: set[int] = set()
        out: list[int] = []
        for tp in self.patterns:
            for v in tp.variables():
                if v not in seen:
                    seen.add(v)
                    out.append(v)
        return tuple(out)

    def __iter__(self) -> Iterator[TriplePattern]:
        return iter(self.patterns)

    def __len__(self) -> int:
        return len(self.patterns)


def star_decomposition(bgp: BGP) -> list[StarPattern]:
    """Def. 7: partition a BGP into star patterns grouped by subject term.

    Properties guaranteed (and property-tested):
      (i)  m <= n,
      (ii) every output group shares a single subject term,
      (iii/iv) the groups exactly partition the input patterns.
    Deterministic: stars ordered by first appearance of their subject.
    """
    order: list[Term] = []
    groups: dict[Term, list[tuple[Term, Term]]] = {}
    for tp in bgp.patterns:
        if tp.s not in groups:
            groups[tp.s] = []
            order.append(tp.s)
        groups[tp.s].append((tp.p, tp.o))
    return [StarPattern(s, tuple(groups[s])) for s in order]


def count_stars(bgp: BGP) -> int:
    """Number of non-trivial stars (>= 2 triple patterns), as the paper
    counts them when naming the 1-star/2-stars/3-stars query loads."""
    return sum(not sp.is_trivial for sp in star_decomposition(bgp))



def bgp_from_tuples(patterns, n_vars: int) -> BGP:
    """A BGP from plain data: ``patterns`` is a sequence of ``(s, p, o)``
    triples of ``(is_var, id)`` tuples, ``n_vars`` the variable count —
    how a BGP written by another implementation of this algebra is
    carried in (no foreign types)."""
    tps = []
    for pat in patterns:
        s, p, o = (Term(bool(v), int(i)) for v, i in pat)
        tps.append(TriplePattern(s, p, o))
    return BGP(tuple(tps), int(n_vars))
