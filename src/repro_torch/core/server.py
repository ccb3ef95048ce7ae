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
torch on the CPU) — this module has no search of its own.

Delta overlay: where the store carries a delta (``_has_delta``: any
insert or tombstone column is non-empty — the port keeps them at their
exact lengths), the four delta-aware evaluators probe base and delta
together (``kops.delta_probe``) and expand over the *merged* runs
(``_merged_expand``), in the order a store rebuilt from the merged
triple set would give; with no delta each takes the base path.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
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
    # owner masking: (my_shard, n_shards) on one shard of a subject-hash
    # sharded store, None on a whole store.  When set, bound-subject
    # probes go through ``kops.eqrange_owned``: rows whose subject another
    # shard owns get empty runs inside the probe, with no mask pass.
    owner: tuple[int, int] | None = None


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


def _has_delta(dev: StoreArrays) -> bool:
    """Is a delta overlaid on the base index?  With none, every evaluator
    runs exactly the base path (no delta probes, no merge)."""
    return dev.ins_key_ps.shape[0] > 0 or dev.tomb_pos_ps.shape[0] > 0


def _probe_run(ctx: EvalCtx, b: BranchPlan, table: BindingTable
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None,
                          torch.Tensor]:
    """Locate each row's ``(p, s)`` run in PSO order (bound-subject cases).

    Returns ``(lo, hi, owned, key)``; ``owned`` is None on a whole store
    and, under owner masking, the rows this shard owns (the others
    already carry an empty run).  The delta overlay probes the same
    composite ``key`` into the insert column; a shard's delta holds only
    triples whose subjects it owns, so a non-owned row misses there too.
    Invalid rows probe whatever their columns hold; ``valid`` masks them
    downstream."""
    s_vals = _term_values(table.rows, b.subj_src, ctx.const_vec)
    key = ctx.const_vec[b.pred_ci] * ctx.radix + s_vals
    if ctx.owner is None:
        lo, hi = kops.eqrange(ctx.dev.key_ps_pso, key)
        return lo, hi, None, key
    my_shard, n_shards = ctx.owner
    lo, hi, owned = kops.eqrange_owned(ctx.dev.key_ps_pso, key, s_vals,
                                       my_shard, n_shards)
    return lo, hi, owned, key


def _probe_active(table: BindingTable, owned: torch.Tensor | None
                  ) -> torch.Tensor:
    """Rows the local store actually probes (owner-masked when sharded)."""
    valid = table.valid if owned is None else table.valid & owned
    return torch.sum(valid.to(torch.int64))


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


def _gather(col: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``col[idx]`` widened to int64, with ``idx`` clamped into the column
    (jnp's gather clamps; torch's raises or faults) and zeros from an
    empty column, which nothing may index."""
    n = col.shape[0]
    if n == 0:
        return torch.zeros(idx.shape, dtype=torch.int64, device=idx.device)
    return col[idx.clamp(0, n - 1)].to(torch.int64)


def _scatter_kept(outs: list, pos: torch.Tensor, srcs: list) -> None:
    """``out[pos] = src`` for each ``(out, src)`` pair, keeping only the
    entries with ``pos < cap`` and dropping the rest (the reference's
    ``.at[pos].set(..., mode="drop")``).  The kept entries are found once
    for all pairs (one host sync); their positions are distinct, so the
    copies are deterministic."""
    kept = torch.nonzero(pos < outs[0].shape[0]).squeeze(1)
    at = pos[kept]
    for out, src in zip(outs, srcs):
        out.index_copy_(0, at, src[kept].to(out.dtype))


def _run_rank(col: torch.Tensor, rlo: torch.Tensor, rhi: torch.Tensor,
              x0: torch.Tensor, col2: torch.Tensor | None = None,
              x1: torch.Tensor | None = None) -> torch.Tensor:
    """Absolute "left" rank of value ``x0`` (or pair ``(x0, x1)`` under
    ``(col, col2)`` lex order) within each sorted run ``col[rlo:rhi)``.

    The pair rank needs no right-sided search: ids are integers, so the
    left rank of ``x0 + 1`` *is* the right rank of ``x0``."""
    a = kops.searchsorted_in_runs(col, rlo, rhi, x0)
    if col2 is None:
        return a
    b = kops.searchsorted_in_runs(col, rlo, rhi, x0 + 1)
    return kops.searchsorted_in_runs(col2, a, b, x1)


def _merged_expand(ctx: EvalCtx, table: BindingTable, lo: torch.Tensor,
                   hi: torch.Tensor, dprobe: tuple, order: str,
                   cols: tuple) -> tuple[list, torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Ragged expansion over *merged* base+delta runs, in sorted order.

    ``lo``/``hi`` are each row's base run, ``dprobe`` the
    ``kops.delta_probe`` result ``(ins_lo, ins_hi, tomb_lo, tomb_hi)`` for
    the same rows, ``order`` picks the tombstone columns ("ps"/"po"), and
    ``cols`` is a tuple of ``(base_col, ins_col)`` pairs in lex
    significance order (one pair for single-column expansions, two for
    the (s, o) pair expansion of ``scan_ovar_free``).

    Both sides scatter directly to their merged ranks (rank-and-scatter):

    - a **live base** element with in-row live rank ``r`` sits at base
      position ``k + rank_right(tomb_adj, k)``, where ``k`` is its global
      live index (``lo - tomb_lo + r``) — the tombstone-select closed
      form — and lands at merged rank ``r`` + (inserts below its value);
    - an **insert** element with in-row rank ``r`` lands at merged rank
      ``r`` + (live base elements below its value), where "live below" is
      (base rank below) - (tombstones below).

    Each side enumerates ``cap`` output slots; a side's scatter position
    is always >= its enumeration index, so every merged output slot below
    ``cap`` is covered — the first-``cap`` truncation of a rebuilt store's
    plain expansion.  Values are unique within a run (triple sets; inserts
    are disjoint from the live base), so kept positions never collide;
    positions at or past ``cap`` are filtered out before the scatter.
    Every gather is clamped, and an empty column is never indexed: with
    exact-length delta columns an inserts-only or tombstones-only delta
    has one of them empty.

    Returns ``(vals, src_row, valid, total)`` with one int32 value column
    per entry of ``cols``.
    """
    dev = ctx.dev
    tomb_pos = dev.tomb_pos_ps if order == "ps" else dev.tomb_pos_po
    tomb_adj = dev.tomb_adj_ps if order == "ps" else dev.tomb_adj_po
    ilo, ihi, tlo, thi = dprobe
    m = cols[0][1].shape[0]  # inserts
    t = tomb_pos.shape[0]  # tombstones
    cap = table.cap
    n_rows = lo.shape[0]
    nb = cols[0][0].shape[0]
    device = lo.device
    i64 = torch.int64

    deg_live = torch.where(table.valid,
                           ((hi - lo) - (thi - tlo)).to(i64), 0)
    deg_ins = torch.where(table.valid, (ihi - ilo).to(i64), 0)
    deg = deg_live + deg_ins
    cum = torch.cumsum(deg, 0)
    total = cum[-1]
    starts = cum - deg
    j = torch.arange(cap, dtype=i64, device=device)

    vals = [torch.zeros(cap, dtype=torch.int32, device=device) for _ in cols]
    src_out = torch.zeros(cap, dtype=torch.int32, device=device)

    # side A: live base elements
    cum_l = torch.cumsum(deg_live, 0)
    starts_l = cum_l - deg_live
    src_a = kops.searchsorted(cum_l, j, side="right").clamp(
        0, n_rows - 1).to(i64)
    r_a = j - starts_l[src_a]
    valid_a = j < cum_l[-1]
    k_glob = (lo[src_a] - tlo[src_a]).to(i64) + r_a
    k_glob = k_glob.clamp(0, max(nb - 1, 0))
    if t:
        q = k_glob + kops.searchsorted(
            tomb_adj, k_glob.to(torch.int32), side="right").to(i64)
    else:
        q = k_glob
    xs = [_gather(bc, q) for bc, _ in cols]
    if m:
        a_lo, a_hi = ilo[src_a], ihi[src_a]
        if len(cols) == 1:
            c_a = _run_rank(cols[0][1], a_lo, a_hi, xs[0])
        else:
            c_a = _run_rank(cols[0][1], a_lo, a_hi, xs[0], cols[1][1], xs[1])
        ins_below = (c_a - a_lo).to(i64)
    else:
        ins_below = 0
    pos_a = torch.where(valid_a, starts[src_a] + r_a + ins_below, cap)
    _scatter_kept(vals + [src_out], pos_a, xs + [src_a])

    # side B: insert elements
    if m:
        cum_i = torch.cumsum(deg_ins, 0)
        starts_i = cum_i - deg_ins
        src_b = kops.searchsorted(cum_i, j, side="right").clamp(
            0, n_rows - 1).to(i64)
        r_b = j - starts_i[src_b]
        valid_b = j < cum_i[-1]
        flat = ilo[src_b].to(i64) + r_b
        bs = [_gather(ic, flat) for _, ic in cols]
        b_lo, b_hi = lo[src_b], hi[src_b]
        if len(cols) == 1:
            p_b = _run_rank(cols[0][0], b_lo, b_hi, bs[0])
        else:
            p_b = _run_rank(cols[0][0], b_lo, b_hi, bs[0], cols[1][0], bs[1])
        below = (p_b - b_lo).to(i64)
        if t:
            below = below - (kops.searchsorted(tomb_pos, p_b, side="left")
                             - tlo[src_b]).to(i64)
        pos_b = torch.where(valid_b, starts[src_b] + r_b + below, cap)
        _scatter_kept(vals + [src_out], pos_b, bs + [src_b])

    return vals, src_out, j < total, total


def _merged_into(ctx: EvalCtx, b: BranchPlan, table: BindingTable,
                 lo: torch.Tensor, hi: torch.Tensor, dprobe: tuple,
                 order: str, cols: tuple, write_subj: bool,
                 write_obj: bool) -> tuple[BindingTable, torch.Tensor]:
    """Materialise a merged expansion into a fresh table (the delta-path
    twin of ``_expand_into``); returns (table, expansion ops)."""
    vals, src, valid, total = _merged_expand(ctx, table, lo, hi, dprobe,
                                             order, cols)
    new_rows = table.rows[src.to(torch.int64)]  # a copy: written in place
    ci = 0
    if write_subj and b.subj_src[0] == "var":
        new_rows[:, b.subj_src[1]] = vals[ci]
        ci += 1
    if write_obj:
        new_rows[:, b.obj_src[1]] = vals[ci]
    overflow = table.overflow | (total > table.cap)
    return (BindingTable(new_rows, valid, overflow),
            torch.clamp(total, max=table.cap))


def probe_filter(ctx: EvalCtx, b: BranchPlan, table: BindingTable
                 ) -> tuple[BindingTable, torch.Tensor]:
    """probe_oconst / probe_ovar_bound: subject and object both bound —
    a pure bind-join membership filter over the (p, s) runs.  Under owner
    masking non-owned rows carry empty runs, so their membership is False
    with no extra mask pass.

    Delta overlay: a base hit only counts if its position is not
    tombstoned, and the insert run can supply the hit instead — the
    merged membership ``(base & ~tomb) | ins``.
    """
    lo, hi, owned, key = _probe_run(ctx, b, table)
    active = _probe_active(table, owned)
    o_vals = _term_values(table.rows, b.obj_src, ctx.const_vec)
    delta = active * (2 * ctx.logn) + active * ctx.logn
    dev = ctx.dev
    if not _has_delta(dev):
        found = kops.run_contains(dev.o_pso, lo, hi, o_vals)
    else:
        pos, found = kops.run_probe(dev.o_pso, lo, hi, o_vals)
        if dev.tomb_pos_ps.shape[0]:
            _, t_hit = kops.sorted_probe(dev.tomb_pos_ps, pos)
            found = found & ~t_hit
        if dev.ins_key_ps.shape[0]:
            ilo, ihi, _, _ = kops.delta_probe(dev.ins_key_ps,
                                              dev.tomb_pos_ps, key, lo, hi)
            found = found | kops.run_contains(dev.ins_o_pso, ilo, ihi,
                                              o_vals)
    return compact(BindingTable(table.rows, table.valid & found,
                                table.overflow)), delta


def probe_ovar_free(ctx: EvalCtx, b: BranchPlan, table: BindingTable
                    ) -> tuple[BindingTable, torch.Tensor]:
    """Subject bound, object free: expand objects within each (p, s) run
    (the merged live-base + insert runs when a delta is overlaid).
    Non-owned rows (empty runs) contribute zero expansion degree."""
    lo, hi, owned, key = _probe_run(ctx, b, table)
    active = _probe_active(table, owned)
    dev = ctx.dev
    if not _has_delta(dev):
        ex = expand(lo, hi, table.valid, table.cap)
        out, ex_ops = _expand_into(ctx, b, table, ex, None, dev.o_pso)
        return out, active * (2 * ctx.logn) + ex_ops
    dp = kops.delta_probe(dev.ins_key_ps, dev.tomb_pos_ps, key, lo, hi)
    out, ex_ops = _merged_into(ctx, b, table, lo, hi, dp, "ps",
                               ((dev.o_pso, dev.ins_o_pso),), False, True)
    return out, active * (2 * ctx.logn) + ex_ops


def scan_obound(ctx: EvalCtx, b: BranchPlan, table: BindingTable
                ) -> tuple[BindingTable, torch.Tensor]:
    """scan_oconst / scan_ovar_bound: subject free, object bound — expand
    subjects out of the (p, o) run in POS order (merged with the POS-side
    delta when one is overlaid)."""
    active = _active(table)
    o_vals = _term_values(table.rows, b.obj_src, ctx.const_vec)
    key = ctx.const_vec[b.pred_ci] * ctx.radix + o_vals
    dev = ctx.dev
    lo, hi = kops.eqrange(dev.key_po_pos, key)
    if not _has_delta(dev):
        ex = expand(lo, hi, table.valid, table.cap)
        out, ex_ops = _expand_into(ctx, b, table, ex, dev.s_pos, None)
        return out, active * (2 * ctx.logn) + ex_ops
    dp = kops.delta_probe(dev.ins_key_po, dev.tomb_pos_po, key, lo, hi)
    out, ex_ops = _merged_into(ctx, b, table, lo, hi, dp, "po",
                               ((dev.s_pos, dev.ins_s_pos),), True, False)
    return out, active * (2 * ctx.logn) + ex_ops


def scan_ovar_free(ctx: EvalCtx, b: BranchPlan, table: BindingTable
                   ) -> tuple[BindingTable, torch.Tensor]:
    """Subject and object free: expand the whole predicate run (PSO order).

    The run is delimited by the "left" ranks of ``p*R`` and ``(p+1)*R`` —
    a single 2-query ``eqrange`` probe of the PSO key column.  With a
    delta the same 2-query batch goes through ``delta_probe`` for the
    insert bounds and tombstone ranks, and the expansion merges by the
    (s, o) pair (both sides are (s, o)-lex within the predicate run).
    """
    active = _active(table)
    p = ctx.const_vec[b.pred_ci]
    qk = torch.stack([p * ctx.radix, (p + 1) * ctx.radix])
    dev = ctx.dev
    bounds, _ = kops.eqrange(dev.key_ps_pso, qk)
    lo = bounds[0].expand(table.cap)
    hi = bounds[1].expand(table.cap)
    if not _has_delta(dev):
        ex = expand(lo, hi, table.valid, table.cap)
        out, ex_ops = _expand_into(ctx, b, table, ex, dev.s_pso, dev.o_pso)
        return out, active * (2 * ctx.logn) + ex_ops
    il, _, tl, _ = kops.delta_probe(dev.ins_key_ps, dev.tomb_pos_ps, qk,
                                    bounds, bounds)
    dp = (il[0].expand(table.cap), il[1].expand(table.cap),
          tl[0].expand(table.cap), tl[1].expand(table.cap))
    out, ex_ops = _merged_into(
        ctx, b, table, lo, hi, dp, "ps",
        ((dev.s_pso, dev.ins_s_pso), (dev.o_pso, dev.ins_o_pso)), True, True)
    return out, active * (2 * ctx.logn) + ex_ops


# --------------------------------------------------------------------------
# unit-level request canonicalization (host-side; the fragment-cache key)
# --------------------------------------------------------------------------

class UnitIO(NamedTuple):
    """What one unit request reads and writes, in canonical form.

    This is the brTPF/SPF request canonicalization: a seeded unit request
    is fully determined by the unit's *structure* (case sequence with
    variables renamed to read/write slots), the constants it mentions, and
    the Omega block restricted to the variables the unit actually reads —
    bindings-restricted semantics make everything else carried payload.
    Two units from different queries that canonicalize identically are the
    same server request, which is what makes star fragments cacheable
    across queries and clients (``core/fragcache.py``).
    """

    canon_sig: tuple  # branch structure with vars renamed to r/w slots
    read_cols: tuple[int, ...]  # table columns the unit reads (bound before)
    write_cols: tuple[int, ...]  # table columns the unit binds
    const_idx: tuple[int, ...]  # positions in const_vec the unit mentions


def unit_io(plan: UnitPlan) -> UnitIO:
    """Derive a unit's canonical I/O signature from its branch plan.

    Variables are renamed to ``("r", i)`` / ``("w", i)`` slots in first-use
    order; a variable bound *within* the unit (a scan'd subject, a free
    object) is a write, and later mentions of it inside the same unit refer
    to the write slot — only externally-bound variables become reads, i.e.
    the relevant bindings of the Omega block.
    """
    reads: list[int] = []
    writes: list[int] = []
    consts: list[int] = []
    written: set[int] = set()

    def slot(var: int, is_write: bool) -> tuple[str, int]:
        if is_write and var not in written:
            written.add(var)
            writes.append(var)
        if var in written:
            return ("w", writes.index(var))
        if var not in reads:
            reads.append(var)
        return ("r", reads.index(var))

    sig = []
    for b in plan.branches:
        consts.append(b.pred_ci)
        s_kind, s_idx = b.subj_src
        if s_kind == "const":
            consts.append(s_idx)
            s_tag: tuple = ("c",)
        else:  # scan cases bind the subject; probe cases read it
            s_tag = slot(s_idx, is_write=b.case.startswith("scan"))
        o_kind, o_idx = b.obj_src
        if o_kind == "const":
            consts.append(o_idx)
            o_tag: tuple = ("c",)
        else:
            o_tag = slot(o_idx, is_write=b.case.endswith("ovar_free"))
        sig.append((b.case, s_tag, o_tag))
    return UnitIO(tuple(sig), tuple(reads), tuple(writes), tuple(consts))


def unit_request_key(io: UnitIO, const_vals: tuple[int, ...],
                     omega_block: np.ndarray, cap: int,
                     epoch: int = 0) -> tuple:
    """Canonical hashable key for one seeded unit request.

    ``const_vals`` are the unit's constants in branch order;
    ``omega_block`` the valid rows restricted to ``io.read_cols`` (int32,
    C-contiguous).  ``cap`` is part of the key because overflow clamping
    and the ops account depend on the table capacity.  ``epoch`` is the
    store epoch (``TripleStore.epoch``) the request is evaluated against:
    folding it into the key guarantees responses computed before a store
    mutation can never alias requests issued after it, even through a
    shared cache (``core/fragcache.py`` additionally drops stale
    entries lazily on lookup).
    """
    block = np.ascontiguousarray(omega_block, dtype=np.int32)
    return (io.canon_sig, const_vals, cap, epoch, block.shape[0],
            block.tobytes())


def unit_digest_key(io: UnitIO, const_vals: tuple[int, ...], cap: int,
                    epoch: int, n_in: int,
                    digest: tuple[int, int, int, int]) -> tuple:
    """Digest form of ``unit_request_key``: the Omega block represented by
    its on-device fingerprint instead of its raw bytes.

    ``digest`` is ``kops.fingerprint_rows`` over the valid prefix of the
    block's read columns (or ``ref.fingerprint_prefix_np`` of the same
    prefix on host-replayed state — bit-identical by construction), and
    ``n_in`` the prefix length.  The digest enters the key as four
    non-negative Python ints, the same ints the JAX reference's keys
    hold, so cache state keyed in either package names the same
    requests.  The scheduler keys the fragment cache
    with this form so a unit step ships 16 bytes per lane to the host
    instead of the whole Omega block.  The ``"fp32x4"`` tag keeps the two
    key forms structurally disjoint — a digest key can never alias a
    byte key that happens to contain the same integers.  Collision risk
    across distinct blocks is that of a 128-bit hash (~2^-64 per pair),
    far below any operational concern.
    """
    return (io.canon_sig, const_vals, cap, epoch, int(n_in),
            ("fp32x4", tuple(int(x) for x in digest)))


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
    are folded in; ``logn`` must be ``log_factor(store.n_triples)``, the
    *logical* count, so that the account equals a rebuilt store's under
    a delta overlay (``None`` derives it from the base key column's
    length, exact whenever the delta is empty).

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
