"""Unit-stepped execution machinery: the serial engine's ladder step and
the scheduler's wave steps.

The single-host half of the JAX reference's stepper, and of its sharded
half the part ``DistributedEngine.run_batch`` runs (the scheduler's
sharded waves are not part of this package yet).  Everything runs
eagerly: where the reference jits each step and caches it by unit
structure, these are plain calls, so there is no step cache.

- ``unit_step``        — the scheduler's wave step: per-lane seeded unit
  evaluation with a provenance column (the source row of every output
  row, which makes computed fragments replayable as cache deltas),
  returning per-lane ``(rows, valid, overflow, src, ops, count, peak)``.
  The reference runs it as ``jit(vmap(lane_fn))``; here the same
  per-lane evaluator runs lane by lane and the outputs are stacked,
  which is what vmap computes.  Lanes nothing reads (no-op padding and
  retired lanes) are skipped.
- ``serial_unit_step`` — the engine's ladder step: one seeded unit
  evaluation returning ``(rows, valid, overflow, ops, count, peak)`` on
  one table (no lane axis, no provenance column).
- ``digest_step``      — the wave fingerprint: one ``kops.fingerprint_rows``
  launch over every lane's read columns, so the fragment cache is
  consulted with a 16-byte digest per lane instead of a host pull of the
  Omega block.  (The wave-wide cache-hit replay is one
  ``kops.replay_delta`` call, made by the scheduler directly.)
- ``reseat``           — capacity regrow/shrink of a compacted table
  (resumable overflow grows exactly one unit's table; the valid prefix is
  preserved, the new tail is UNBOUND-filled).
- ``unit_cost``        — host twin of ``engine._execute``'s per-unit cost
  accounting, shared by the planned serial path and the scheduler.
- ``endpoint_totals``  — the endpoint interface's whole-query (nrs, ntb).
- ``eval_unit_sharded`` — one unit over a subject-hash-sharded store: each
  shard evaluates the whole unit on its own (star locality makes the
  branch joins shard-local), and the serial cost account is rebuilt from
  the sums of the shards' branch-boundary counts.
- ``gather_merge_kway`` — the shards' local output blocks merged back into
  the serial row order: the reference's fold / recursive-doubling
  schedule of pairwise ``merge_sorted_blocks`` over a list of blocks
  (its ``ppermute`` exchanges), each merge two lexicographic rank
  searches (``kops.searchsorted_in_runs``) and one exact scatter.
- ``shard_trim``       — the per-shard gather budget for a lane capacity.

Shards are an axis on one card, evaluated in a loop, as lanes are: where
the reference's collectives run inside ``shard_map``, a ``psum`` here is
a sum over the shard loop, an ``all_gather`` a list and a ``ppermute``
the pairing of two list entries.
"""

from __future__ import annotations

import torch

from repro_torch.core.bindings import UNBOUND, BindingTable
from repro_torch.core.server import (
    BRANCH_EVALUATORS,
    EvalCtx,
    UnitPlan,
    eval_unit,
)
from repro_torch.kernels import ops as kops


def unit_step(up: UnitPlan, radix: int, logn: int | None = None):
    """The scheduler's wave step for unit ``up``:

        step(dev, consts[B, n_c], rows[B, cap, V], valid[B, cap],
             overflow[B], active=None)
        -> (rows, valid, overflow, src[B, cap], ops[B], count[B], peak[B])

    Each lane in ``active`` (every lane when ``None``) runs ``eval_unit``
    on its table with a provenance column ``arange(cap)`` appended; the
    column is stripped off again as ``src``.  A lane outside ``active``
    is not evaluated: it comes out as an empty UNBOUND table (``src``
    UNBOUND too), ``ops = count = peak = 0`` and its overflow flag
    unchanged — the scheduler reads only active lanes.  ``logn`` carries
    the logical-count cost factor.
    """
    def step(dev, consts, rows, valid, overflow, active=None):
        n_lanes, cap, n_vars = rows.shape
        device = rows.device
        prov = torch.arange(cap, dtype=torch.int32, device=device)[:, None]
        lanes = range(n_lanes) if active is None else set(active)
        zero = torch.zeros((), dtype=torch.int64, device=device)
        empty_rows = torch.full((cap, n_vars), UNBOUND, dtype=torch.int32,
                                device=device)
        empty_src = torch.full((cap,), UNBOUND, dtype=torch.int32,
                               device=device)
        empty_valid = torch.zeros(cap, dtype=torch.bool, device=device)
        outs = []
        for j in range(n_lanes):
            if j not in lanes:
                outs.append((empty_rows, empty_valid, overflow[j], empty_src,
                             zero, zero, zero))
                continue
            table = BindingTable(torch.cat([rows[j], prov], dim=1), valid[j],
                                 overflow[j])
            table, ops, peak = eval_unit(dev, radix, up, consts[j], table,
                                         logn=logn)
            outs.append((table.rows[:, :-1], table.valid, table.overflow,
                         table.rows[:, -1], ops, table.count(), peak))
        return tuple(torch.stack(list(col)) for col in zip(*outs))

    return step


def serial_unit_step(up: UnitPlan, radix: int, logn: int | None = None):
    """The serial engine's ladder step for unit ``up``:
    ``step(dev, const_vec, rows, valid, overflow) -> (rows, valid,
    overflow, ops, count, peak)`` on one table (no lane axis).  ``logn``
    carries the logical-count cost factor."""
    def step(dev, const_vec, rows, valid, overflow):
        table, ops, peak = eval_unit(dev, radix, up, const_vec,
                                     BindingTable(rows, valid, overflow),
                                     logn=logn)
        return (table.rows, table.valid, table.overflow, ops,
                torch.sum(table.valid.to(torch.int64)), peak)

    return step


def digest_step(rows: torch.Tensor, valid: torch.Tensor,
                read_cols: tuple[int, ...]) -> torch.Tensor:
    """The wave fingerprint: ``int64[B, 4]``, the digest of each lane's
    valid rows of ``rows[B, cap, V]`` restricted to ``read_cols`` (a
    zero-width block when there are none), in one ``kops.fingerprint_rows``
    call — the device half of the digest-first cache keys (host twin:
    ``ref.fingerprint_prefix_np``)."""
    if read_cols:
        idx = torch.tensor(read_cols, dtype=torch.int64, device=rows.device)
        block = rows.index_select(2, idx)
    else:
        block = rows.new_empty((rows.shape[0], rows.shape[1], 0))
    return kops.fingerprint_rows(block, valid)


def reseat(rows: torch.Tensor, valid: torch.Tensor, new_cap: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-home a compacted table at a new capacity.

    Growing pads the tail with UNBOUND rows; shrinking drops tail rows
    (callers guarantee the valid prefix fits).  The valid prefix is
    preserved bit-for-bit, which is what makes re-entering the ladder at
    the overflowed unit byte-identical to the blind whole-query retry.
    """
    cap, n_vars = rows.shape
    if new_cap <= cap:
        return rows[:new_cap], valid[:new_cap]
    pad = new_cap - cap
    return (torch.cat([rows, torch.full((pad, n_vars), UNBOUND,
                                        dtype=rows.dtype,
                                        device=rows.device)]),
            torch.cat([valid, torch.zeros(pad, dtype=valid.dtype,
                                          device=valid.device)]))


def endpoint_totals(cfg, n_results: int, n_vars: int) -> tuple[int, int]:
    """(nrs, ntb) of a whole endpoint-interface query — the host twin of
    ``engine._execute``'s end-of-query override (one request, the full
    result set in one response)."""
    return (1, cfg.request_base_bytes + n_results * n_vars * cfg.term_bytes
            + cfg.page_header_bytes)


def unit_cost(cfg, k: int, up: UnitPlan, in_count: int, out_count: int,
              ops: int, probe_ops: int) -> tuple[int, int, int, int]:
    """(nrs, ntb, server_ops, client_ops) deltas for one unit, in ints.

    Mirrors the accounting in ``engine._execute`` exactly.  ``k`` is the
    unit's absolute position in the plan (resumed executions keep their
    original indices).  ``probe_ops`` is the per-probe cost of the TPF
    fragment-location path (``kops.probe_op_cost``), unused by the other
    interfaces.
    """
    tb = cfg.term_bytes
    matched = out_count * up.n_triple_patterns
    if cfg.interface == "endpoint":
        return 0, 0, ops, 0
    meta = 1
    if cfg.interface == "tpf":
        blocks = max(in_count, 1) if k > 0 else 1
    else:  # brtpf / spf: Omega-blocked requests
        blocks = -(-max(in_count, 1) // cfg.omega) if k > 0 else 1
    pages = -(-max(out_count, 1) // cfg.page_size)
    extra = max(pages - blocks, 0)
    nrs_d = meta + blocks + extra
    sent = (blocks + meta + extra) * cfg.request_base_bytes
    if cfg.interface in ("brtpf", "spf") and k > 0:
        n_bound_vars = len(
            {v for b in up.branches for src in (b.subj_src, b.obj_src)
             if src[0] == "var" for v in [src[1]]})
        sent += in_count * max(n_bound_vars, 1) * tb
    recv = matched * 3 * tb + (pages + meta) * cfg.page_header_bytes
    ntb_d = sent + recv
    if cfg.interface == "tpf":
        server_d = blocks * probe_ops + matched
        client_d = ops
    else:
        server_d = ops
        client_d = out_count
    return nrs_d, ntb_d, server_d, client_d


# --------------------------------------------------------------------------
# sharded-store unit evaluation (DistributedEngine.run_batch's lane)
# --------------------------------------------------------------------------

# branch cases that only filter (their output count never exceeds their
# input count); every other case is a ragged expansion
_FILTER_CASES = frozenset({"probe_oconst", "probe_ovar_bound"})


def eval_unit_sharded(devs, radix: int, up: UnitPlan,
                      const_vec: torch.Tensor, table: BindingTable, *,
                      logn: int, owner: bool = False):
    """One unit's branches against every shard of a subject-hash-sharded
    store, shard by shard.

    ``devs`` holds each shard's ``StoreArrays`` (``len(devs)`` shards)
    and ``table`` is the lane's input, the same for every shard.  Because
    the store is subject-hash sharded and all branches of a star share
    the subject, each row's whole evaluation happens on exactly one shard
    — the others find empty runs — so a shard's branch loop reads nothing
    of another's, and the local output tables partition the serial output
    by subject owner.  With ``owner`` set, a unit whose first branch is a
    probe (bound subject) runs it through ``kops.eqrange_owned`` with
    ``(shard, n_shards)``: the same rows, fewer index reads.

    The serial cost account is rebuilt from the branch-boundary counts
    summed over the shards (the reference's scalar ``psum``s; the
    branches' own ops deltas are not read):

        filter     ops += count_in * 3 * logn
        expansion  ops += count_in * 2 * logn + min(total, cap)

    where ``total`` is the sum of the shards' local counts,
    ``count_in`` the previous boundary's ``min(total, cap)`` (the input's
    count at the first) and ``logn`` the *global* store's log-factor of
    its logical count (a shard's own would drift from the serial
    account).  Overflow is global too: an expansion whose total exceeds
    the capacity overflows even when every shard fit, exactly when the
    serial evaluation would; any shard's own overflow flag is OR'ed in.

    Returns ``(local_tables, ops, peak, count, overflow)``: one output
    table per shard, to be merged by ``gather_merge_kway``, and the
    lane's account as device scalars.
    """
    n_shards = len(devs)
    cap = table.cap
    masked = owner and up.branches[0].case.startswith("probe")
    tables, counts = [], []
    for i, dev in enumerate(devs):
        ctx = EvalCtx(dev, radix, const_vec, logn,
                      (i, n_shards) if masked else None)
        local, local_counts = table, []
        for b in up.branches:
            local, _ = BRANCH_EVALUATORS[b.case](ctx, b, local)
            local_counts.append(local.count())
        tables.append(local)
        counts.append(local_counts)
    cnt = table.count()
    ops = torch.zeros((), dtype=torch.int64, device=cnt.device)
    peak = cnt
    over = torch.zeros((), dtype=torch.bool, device=cnt.device)
    for k, b in enumerate(up.branches):
        total = torch.stack([c[k] for c in counts]).sum()
        if b.case in _FILTER_CASES:
            ops = ops + cnt * (3 * logn)
        else:
            ops = ops + cnt * (2 * logn) + total.clamp(max=cap)
            over = over | (total > cap)
        cnt = total.clamp(max=cap)
        peak = torch.maximum(peak, cnt)
    over = over | torch.stack([t.overflow for t in tables]).any()
    return tables, ops, peak, cnt, over


def shard_trim(cap: int, n_shards: int, headroom: int = 2) -> int:
    """Per-shard gather budget for a lane capacity of ``cap``.

    A balanced subject hash puts ~``cap / n_shards`` of a lane's rows on
    each shard, so a shard ships ``headroom`` times that (skew margin)
    instead of the full capacity, floored at the capacity quantum
    (``CapacityPlanner.MIN_QUANTUM``), below which trimming buys nothing.
    ``n_shards * trim`` always covers ``cap``, so a fitting result is
    never truncated.
    """
    from repro_torch.core.capacity import CapacityPlanner

    if n_shards <= 1:
        return cap
    return min(cap, max(headroom * (-(-cap // n_shards)),
                        CapacityPlanner.MIN_QUANTUM))


def _merge_keys(rows: torch.Tensor, valid: torch.Tensor,
                sort_cols: tuple[int, ...]) -> list[torch.Tensor]:
    """Key columns of a block under the merge order ``(~valid,
    *sort_cols)``, contiguous int32, most significant first."""
    return [(~valid).to(torch.int32)] + \
        [rows[:, c].to(torch.int32).contiguous() for c in sort_cols]


def _lex_rank_range(keys_s: list[torch.Tensor], keys_q: list[torch.Tensor]
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Equal ranges of each query row's key tuple within a block sorted by
    the same key order: per key column, narrow ``[lo, hi)`` by a
    within-run two-sided search (``kops.searchsorted_in_runs``, the run
    probe on the card).  Returns ``(lo, hi)`` = (#rows strictly below,
    #rows at or below) per query, int32."""
    n_s = keys_s[0].shape[0]
    n_q = keys_q[0].shape[0]
    device = keys_q[0].device
    lo = torch.zeros(n_q, dtype=torch.int32, device=device)
    hi = torch.full((n_q,), n_s, dtype=torch.int32, device=device)
    for cs, cq in zip(keys_s, keys_q):
        # the block is sorted by this column within ties of the earlier
        # ones; the left rank of x + 1 is the right rank of x (integers)
        t = cq.to(torch.int64)
        lo_new = kops.searchsorted_in_runs(cs, lo, hi, t)
        hi = kops.searchsorted_in_runs(cs, lo, hi, t + 1)
        lo = lo_new
    return lo, hi


def merge_sorted_blocks(rows_a: torch.Tensor, valid_a: torch.Tensor,
                        rows_b: torch.Tensor, valid_b: torch.Tensor,
                        sort_cols: tuple[int, ...]
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Linear merge of two row blocks, each already sorted by ``(~valid,
    *sort_cols)``; block A wins ties (stability).

    Rank-based, not compare-and-advance: each A row lands at its own
    index plus the count of B rows strictly below it, each B row at its
    index plus the count of A rows at or below it — two lexicographic
    rank computations (``_lex_rank_range``) and one scatter.  The
    positions are a permutation of the output, so the scatter
    (``index_copy_``) is exact.  Returns the merged ``(rows, valid)`` of
    length ``len(A) + len(B)``.
    """
    n_a = rows_a.shape[0]
    n_b, width = rows_b.shape
    device = rows_a.device
    keys_a = _merge_keys(rows_a, valid_a, sort_cols)
    keys_b = _merge_keys(rows_b, valid_b, sort_cols)
    b_below_a, _ = _lex_rank_range(keys_b, keys_a)
    _, a_at_or_below_b = _lex_rank_range(keys_a, keys_b)
    pos_a = torch.arange(n_a, device=device) + b_below_a.to(torch.int64)
    pos_b = torch.arange(n_b, device=device) \
        + a_at_or_below_b.to(torch.int64)
    rows_m = torch.zeros((n_a + n_b, width), dtype=rows_a.dtype,
                         device=device)
    rows_m.index_copy_(0, pos_a, rows_a).index_copy_(0, pos_b, rows_b)
    valid_m = torch.zeros(n_a + n_b, dtype=valid_a.dtype, device=device)
    valid_m.index_copy_(0, pos_a, valid_a).index_copy_(0, pos_b, valid_b)
    return rows_m, valid_m


def _trim_block(rows: torch.Tensor, valid: torch.Tensor, trim: int):
    """Clip a local block to its gather budget and blank the invalid tail.

    Invalid rows are overwritten with -1, so the merge sees and emits the
    same bytes outside the valid prefix as the reference's lexsort
    (all-(-1) rows sorted to the back).  Returns ``(rows, valid, lost)``
    with ``lost`` = this shard dropped a valid row past the trim.
    """
    lost = torch.zeros((), dtype=torch.bool, device=valid.device)
    if trim < rows.shape[0]:
        lost = valid[trim:].any()
        rows, valid = rows[:trim], valid[:trim]
    return torch.where(valid[:, None], rows, UNBOUND), valid, lost


def _pad_to_cap(rows: torch.Tensor, valid: torch.Tensor, out_cap: int, lost):
    n, width = rows.shape
    if n >= out_cap:
        return rows[:out_cap], valid[:out_cap], lost
    pad = out_cap - n
    return (torch.cat([rows, torch.full((pad, width), UNBOUND,
                                        dtype=rows.dtype,
                                        device=rows.device)]),
            torch.cat([valid, torch.zeros(pad, dtype=valid.dtype,
                                          device=valid.device)]), lost)


def gather_merge_kway(blocks, sort_cols: tuple[int, ...], out_cap: int,
                      trim: int):
    """The shards' local output blocks merged back into the lane table in
    *serial row order*: ``(rows[out_cap], valid[out_cap], lost)``.

    ``blocks`` holds each shard's ``(rows, valid)`` in shard order.  Each
    local table holds the serial output restricted to one shard, already
    in serial order, and every row carries its sort key in its own
    columns (``sort_cols``: the provenance column, then the values the
    unit's expansions drew, which runs are sorted by), so merging the
    sorted blocks reproduces the serial table byte for byte.  Each block
    is first trimmed to ``trim`` rows (``_trim_block``); ``lost`` is
    whether any shard dropped a valid row there.

    The schedule is the reference's over ``ppermute`` (``base`` the
    largest power of two <= the shard count): a pre-round folds block
    ``base + i`` into block ``i``, then rounds of recursive doubling
    merge partner blocks with the lower index on the left, until one
    merged block remains (the reference's broadcast back to the extra
    shards has nothing to copy here).  The reference merges each block
    without an extra partner with an all-invalid one in the pre-round;
    that only lengthens the invalid tail, which ``_pad_to_cap`` cuts or
    pads to ``out_cap`` all the same, so it is skipped.
    """
    trimmed = [_trim_block(r, v, trim) for r, v in blocks]
    lost = torch.stack([t[2] for t in trimmed]).any()
    merged = [(r, v) for r, v, _ in trimmed]
    base = 1 << (len(merged).bit_length() - 1)
    for i in range(len(merged) - base):
        merged[i] = merge_sorted_blocks(*merged[i], *merged[base + i],
                                        sort_cols)
    merged = merged[:base]
    while len(merged) > 1:
        merged = [merge_sorted_blocks(*merged[j], *merged[j + 1], sort_cols)
                  for j in range(0, len(merged), 2)]
    return _pad_to_cap(*merged[0], out_cap, lost)
