"""Server-side fragment evaluation: planning + star/TP evaluation on tensors.

A *unit* is what one request evaluates — a star pattern for the SPF
interface, a single triple pattern for TPF/brTPF (a 1-branch star).  The
evaluator is *seeded*: it receives the current table of solution mappings
(the paper's Omega) and extends/filters it, which is exactly bind-join /
bindings-restricted semantics (Def. 5, non-empty-Omega case).

Planning is host-side and uses exact run lengths from the store's numpy
indexes (= the Def. 6 cardinality metadata, eps = 0); evaluation runs
eagerly on the store's device.  Every constant id reaches the evaluators
through the int64 ``const_vec`` tensor, as in the JAX reference.

Branch cases (derived at plan time from the bound-variable set):

    probe_oconst      subject bound, object const          -> filter
    probe_ovar_bound  subject bound, object var bound      -> filter
    probe_ovar_free   subject bound, object var free       -> expand objects
    scan_oconst       subject free,  object const          -> expand subjects (POS run)
    scan_ovar_bound   subject free,  object var bound      -> expand subjects (POS eqrange)
    scan_ovar_free    subject free,  object var free       -> expand pred run (PSO)

Each case is one small evaluator in ``BRANCH_EVALUATORS``; ``eval_unit``
walks the plan and dispatches.  Every probe/membership primitive routes
through ``repro_torch.kernels.ops`` (the CUDA kernels on the card, plain
torch on the CPU) — this module has no search of its own.  The store here
carries no delta overlay (its delta tensors are zero-length), so every
evaluator takes the base path of the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.core.bindings import (
    BindingTable,
    Expansion,
    compact,
    expand,
)
from repro_torch.core.patterns import StarPattern
from repro_torch.kernels import ops as kops
from repro_torch.rdf.store import StoreArrays, TripleStore


# --------------------------------------------------------------------------
# plans (host-side, static)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class BranchPlan:
    case: str  # one of the six tags above
    pred_ci: int  # index into const_vec (predicate id)
    subj_src: tuple[str, int]  # ("var", var_idx) | ("const", const_vec idx)
    obj_src: tuple[str, int]  # ("var", var_idx) | ("const", const_vec idx)
    est_card: int  # host-side run length (planning metadata)


@dataclass(frozen=True)
class UnitPlan:
    branches: tuple[BranchPlan, ...]
    est_card: int  # Def. 6 metadata estimate for the whole unit
    n_triple_patterns: int

    @property
    def signature(self) -> tuple:
        """Structure key: case structure without constant values."""
        return tuple((b.case, b.subj_src[0], b.obj_src[0],
                      b.subj_src[1] if b.subj_src[0] == "var" else -1,
                      b.obj_src[1] if b.obj_src[0] == "var" else -1)
                     for b in self.branches)


def plan_unit(store: TripleStore, star: StarPattern, bound: frozenset[int],
              consts: list[int]) -> tuple[UnitPlan, frozenset[int]]:
    """Plan one unit given the currently bound variable set.

    Branch order: most selective first (smallest host cardinality), with the
    constraint that once the subject is bound all remaining branches become
    probes.  Returns the plan and the updated bound set.
    """
    if not star.subject.is_var and star.subject.id is None:
        raise ValueError("invalid subject term")

    def add_const(cid: int) -> int:
        consts.append(int(cid))
        return len(consts) - 1

    # host cardinalities per branch (before binding anything)
    infos = []
    for p_term, o_term in star.branches:
        if p_term.is_var:
            raise NotImplementedError(
                "unbound-predicate patterns are outside the WatDiv loads; "
                "the SPF server would fall back to a full scan")
        p = p_term.id
        if not o_term.is_var:
            card = store.tp_cardinality(p, o=o_term.id)
        else:
            card = store.tp_cardinality(p)
        infos.append((card, p_term, o_term))
    # selective-first ordering; const-object branches are naturally smallest
    infos.sort(key=lambda t: t[0])

    subj = star.subject
    subj_bound = (not subj.is_var) or (subj.id in bound)
    new_bound = set(bound)
    branches: list[BranchPlan] = []
    for card, p_term, o_term in infos:
        p_ci = add_const(p_term.id)
        subj_src = ("const", add_const(subj.id)) if not subj.is_var else ("var", subj.id)
        if not o_term.is_var:
            obj_src = ("const", add_const(o_term.id))
            case = "probe_oconst" if subj_bound else "scan_oconst"
        elif o_term.id in new_bound:
            obj_src = ("var", o_term.id)
            case = "probe_ovar_bound" if subj_bound else "scan_ovar_bound"
        else:
            obj_src = ("var", o_term.id)
            case = "probe_ovar_free" if subj_bound else "scan_ovar_free"
            new_bound.add(o_term.id)
        branches.append(BranchPlan(case, p_ci, subj_src, obj_src, card))
        if not subj_bound:
            subj_bound = True
            if subj.is_var:
                new_bound.add(subj.id)

    est = min(i[0] for i in infos)
    return (UnitPlan(tuple(branches), est, len(star.branches)),
            frozenset(new_bound))


# --------------------------------------------------------------------------
# evaluation: one small evaluator per branch case
# --------------------------------------------------------------------------

class EvalCtx(NamedTuple):
    """Per-unit evaluation context shared by the branch evaluators."""

    dev: StoreArrays
    radix: int
    const_vec: torch.Tensor  # int64[n_consts], on the store's device
    logn: int  # ceil(log2 n): the cost model's binary-search factor


# evaluator signature: (ctx, branch, table) -> (table, ops_delta)
BranchEvaluator = Callable[[EvalCtx, BranchPlan, BindingTable],
                           tuple[BindingTable, torch.Tensor]]


def _term_values(rows: torch.Tensor, src: tuple[str, int],
                 const_vec: torch.Tensor) -> torch.Tensor:
    """One int64 value per row: the constant broadcast, or the variable's
    column widened from int32.  Always contiguous (the kernels take no
    strided input)."""
    kind, idx = src
    if kind == "const":
        return const_vec[idx].expand(rows.shape[0]).contiguous()
    return rows[:, idx].to(torch.int64).contiguous()


def _active(table: BindingTable) -> torch.Tensor:
    return torch.sum(table.valid.to(torch.int64))


def _probe_run(ctx: EvalCtx, b: BranchPlan, table: BindingTable
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Locate each row's ``(p, s)`` run in PSO order (bound-subject cases).
    Invalid rows probe whatever their columns hold; ``valid`` masks them
    downstream."""
    s_vals = _term_values(table.rows, b.subj_src, ctx.const_vec)
    key = ctx.const_vec[b.pred_ci] * ctx.radix + s_vals
    return kops.eqrange(ctx.dev.key_ps_pso, key)


def _expand_into(ctx: EvalCtx, b: BranchPlan, table: BindingTable,
                 ex: Expansion, subj_from: torch.Tensor | None,
                 obj_from: torch.Tensor | None
                 ) -> tuple[BindingTable, torch.Tensor]:
    """Materialise an expansion into a fresh table, filling var columns
    from the given store columns; returns (table, expansion ops)."""
    # advanced indexing copies, so the column writes below are in place on
    # a fresh tensor (the reference's out-of-place .at[:, c].set).  Every
    # index is in range: src_row is clamped by expand, and flat_idx lies
    # inside a run for valid slots and is 0 for the rest.
    new_rows = table.rows[ex.src_row.to(torch.int64)]
    if subj_from is not None and b.subj_src[0] == "var":
        new_rows[:, b.subj_src[1]] = subj_from[ex.flat_idx]
    if obj_from is not None:
        new_rows[:, b.obj_src[1]] = obj_from[ex.flat_idx]
    overflow = table.overflow | (ex.total > table.cap)
    return (BindingTable(new_rows, ex.valid, overflow),
            torch.clamp(ex.total, max=table.cap))


def probe_filter(ctx: EvalCtx, b: BranchPlan, table: BindingTable
                 ) -> tuple[BindingTable, torch.Tensor]:
    """probe_oconst / probe_ovar_bound: subject and object both bound —
    a pure bind-join membership filter over the (p, s) runs."""
    lo, hi = _probe_run(ctx, b, table)
    active = _active(table)
    o_vals = _term_values(table.rows, b.obj_src, ctx.const_vec)
    delta = active * (2 * ctx.logn) + active * ctx.logn
    found = kops.run_contains(ctx.dev.o_pso, lo, hi, o_vals)
    return compact(BindingTable(table.rows, table.valid & found,
                                table.overflow)), delta


def probe_ovar_free(ctx: EvalCtx, b: BranchPlan, table: BindingTable
                    ) -> tuple[BindingTable, torch.Tensor]:
    """Subject bound, object free: expand objects within each (p, s) run."""
    lo, hi = _probe_run(ctx, b, table)
    active = _active(table)
    ex = expand(lo, hi, table.valid, table.cap)
    out, ex_ops = _expand_into(ctx, b, table, ex, None, ctx.dev.o_pso)
    return out, active * (2 * ctx.logn) + ex_ops


def scan_obound(ctx: EvalCtx, b: BranchPlan, table: BindingTable
                ) -> tuple[BindingTable, torch.Tensor]:
    """scan_oconst / scan_ovar_bound: subject free, object bound — expand
    subjects out of the (p, o) run in POS order."""
    active = _active(table)
    o_vals = _term_values(table.rows, b.obj_src, ctx.const_vec)
    key = ctx.const_vec[b.pred_ci] * ctx.radix + o_vals
    lo, hi = kops.eqrange(ctx.dev.key_po_pos, key)
    ex = expand(lo, hi, table.valid, table.cap)
    out, ex_ops = _expand_into(ctx, b, table, ex, ctx.dev.s_pos, None)
    return out, active * (2 * ctx.logn) + ex_ops


def scan_ovar_free(ctx: EvalCtx, b: BranchPlan, table: BindingTable
                   ) -> tuple[BindingTable, torch.Tensor]:
    """Subject and object free: expand the whole predicate run (PSO order).

    The run is delimited by the "left" ranks of ``p*R`` and ``(p+1)*R`` —
    a single 2-query ``eqrange`` probe of the PSO key column.
    """
    active = _active(table)
    p = ctx.const_vec[b.pred_ci]
    qk = torch.stack([p * ctx.radix, (p + 1) * ctx.radix])
    bounds, _ = kops.eqrange(ctx.dev.key_ps_pso, qk)
    lo = bounds[0].expand(table.cap)
    hi = bounds[1].expand(table.cap)
    ex = expand(lo, hi, table.valid, table.cap)
    out, ex_ops = _expand_into(ctx, b, table, ex, ctx.dev.s_pso,
                               ctx.dev.o_pso)
    return out, active * (2 * ctx.logn) + ex_ops


BRANCH_EVALUATORS: dict[str, BranchEvaluator] = {
    "probe_oconst": probe_filter,
    "probe_ovar_bound": probe_filter,
    "probe_ovar_free": probe_ovar_free,
    "scan_oconst": scan_obound,
    "scan_ovar_bound": scan_obound,
    "scan_ovar_free": scan_ovar_free,
}


def log_factor(n: int) -> int:
    """``ceil(log2 n)`` floored at 1 — the cost model's binary-search
    factor.  The single point of truth for the serial evaluator and the
    host accounting."""
    return max(1, int(math.ceil(math.log2(max(int(n), 2)))))


def eval_unit(dev: StoreArrays, radix: int, plan: UnitPlan,
              const_vec: torch.Tensor, table: BindingTable,
              logn: int | None = None
              ) -> tuple[BindingTable, torch.Tensor, torch.Tensor]:
    """Evaluate one unit seeded with ``table``; returns (table, ops, peak).

    ``ops`` counts probe/expansion work (an int64 device scalar) — the
    server/client load accounting uses it.  Log-factors of binary searches
    are folded in; ``logn`` is ``log_factor(store.n_triples)`` (``None``
    derives it from the key column's length, the same number here).

    ``peak`` is the max row count at any branch boundary, input included —
    on a non-overflowing evaluation exactly the capacity the unit
    *needed*, which the capacity planner records as the unit's
    high-water mark.  On an overflowed evaluation it is clamped at the
    capacity and unused.
    """
    if logn is None:
        logn = log_factor(dev.key_ps_pso.shape[0])
    ctx = EvalCtx(dev, radix, const_vec, logn)
    ops_total = torch.zeros((), dtype=torch.int64, device=table.rows.device)
    peak = table.count()
    for b in plan.branches:
        table, delta = BRANCH_EVALUATORS[b.case](ctx, b, table)
        ops_total = ops_total + delta
        peak = torch.maximum(peak, table.count())
    return table, ops_total, peak
