"""Unit-stepped execution machinery for the serial engine.

The serial half of the JAX reference's stepper:

- ``serial_unit_step`` — the engine's ladder step: one seeded unit
  evaluation returning ``(rows, valid, overflow, ops, count, peak)``.  The
  reference batches it over a leading lane axis and jits it per unit
  structure; here it runs eagerly on one table, so the lane axis and the
  compile cache are gone.
- ``reseat``           — capacity regrow/shrink of a compacted table
  (resumable overflow grows exactly one unit's table; the valid prefix is
  preserved, the new tail is UNBOUND-filled).
- ``unit_cost``        — host twin of ``engine._execute``'s per-unit cost
  accounting, for the planned serial path.
- ``endpoint_totals``  — the endpoint interface's whole-query (nrs, ntb).
"""

from __future__ import annotations

import torch

from repro_torch.core.bindings import UNBOUND, BindingTable
from repro_torch.core.server import UnitPlan, eval_unit


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
