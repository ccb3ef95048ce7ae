"""Unit-stepped execution machinery: the serial engine's ladder step and
the scheduler's wave steps.

The single-host half of the JAX reference's stepper (the sharded
lowering is not part of this package yet).  Everything runs eagerly:
where the reference jits each step and caches it by unit structure,
these are plain calls, so there is no step cache.

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
"""

from __future__ import annotations

import torch

from repro_torch.core.bindings import UNBOUND, BindingTable
from repro_torch.core.server import UnitPlan, eval_unit
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
