"""Fixed-capacity solution-mapping tables and ragged expansion.

A set of solution mappings (the paper's Omega / intermediate results) is a
fixed-capacity table, as in the JAX reference, so that valid rows and
overflow flags stay byte-identical to it, including at the capacity
latch:

    rows    int32[cap, n_vars]   (-1 = unbound)
    valid   bool[cap]            valid rows form a prefix (tables are kept
                                 compacted after filtering steps)
    overflow bool[]              capacity was exceeded somewhere upstream —
                                 the analogue of the paper's 10-min timeout.

The search primitives the tables are joined with (``eqrange``,
``run_probe`` / ``run_contains``) live in the dispatch layer
``repro_torch.kernels.ops``.  This module keeps the table machinery:

- ``expand``: given per-row runs ``[lo_i, hi_i)``, enumerate (row, element)
  pairs into a fresh table of capacity ``cap`` via cumsum + searchsorted —
  the prefix-sum trick for ragged expansion at a fixed capacity.  Its
  ``searchsorted`` over the cumulative-degree vector goes through
  ``kops.searchsorted``, so on the card it is a sorted-probe launch.
- ``compact`` / ``set_column``: table maintenance.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops

UNBOUND = -1


class BindingTable(NamedTuple):
    rows: torch.Tensor  # int32[cap, n_vars]
    valid: torch.Tensor  # bool[cap]
    overflow: torch.Tensor  # bool scalar

    @property
    def cap(self) -> int:
        return self.rows.shape[0]

    @property
    def n_vars(self) -> int:
        return self.rows.shape[1]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid.to(torch.int64))


def unit_table(cap: int, n_vars: int, device=None) -> BindingTable:
    """Table with a single all-unbound row — the evaluation seed (Omega with
    the empty mapping), matching Def. 5's empty-Omega case.  ``device``
    is where the tensors live (the caller's store device)."""
    rows = torch.full((cap, n_vars), UNBOUND, dtype=torch.int32,
                      device=device)
    valid = torch.zeros(cap, dtype=torch.bool, device=device)
    valid[0] = True  # in-place on the fresh tensor (jnp: .at[0].set)
    return BindingTable(rows, valid,
                        torch.zeros((), dtype=torch.bool, device=device))


# --------------------------------------------------------------------------
# ragged expansion
# --------------------------------------------------------------------------

class Expansion(NamedTuple):
    src_row: torch.Tensor  # int32[cap]   source row index per output row
    flat_idx: torch.Tensor  # int64[cap]  absolute index into the store array
    valid: torch.Tensor  # bool[cap]
    total: torch.Tensor  # int64 scalar: true (unclamped) number of outputs


def expand(lo: torch.Tensor, hi: torch.Tensor, row_valid: torch.Tensor,
           cap: int) -> Expansion:
    """Enumerate (row, run element) pairs for per-row runs ``[lo_i, hi_i)``.

    Output row ``j`` draws from source row ``src = searchsorted(cumdeg, j)``
    at offset ``j - cumdeg[src-1]``.  Rows with ``row_valid=False``
    contribute degree 0.  Output valid rows form a prefix by construction.
    ``src`` is clamped into ``[0, rows)`` before it indexes (the slots past
    the total rank past the last row); invalid slots get ``flat_idx`` 0.
    """
    deg = torch.where(row_valid, (hi - lo).to(torch.int64), 0)
    cum = torch.cumsum(deg, 0)
    total = cum[-1]
    starts = cum - deg
    j = torch.arange(cap, dtype=torch.int64, device=lo.device)
    src = kops.searchsorted(cum, j, side="right")
    src_c = src.clamp(0, lo.shape[0] - 1).to(torch.int64)
    r = j - starts[src_c]
    flat = lo[src_c].to(torch.int64) + r
    valid = j < total
    flat = torch.where(valid, flat, 0)
    return Expansion(
        src_row=src_c.to(torch.int32),
        flat_idx=flat,
        valid=valid,
        total=total,
    )


def compact(table: BindingTable) -> BindingTable:
    """Stable-partition valid rows to a prefix: a stable argsort of
    ``~valid`` (as uint8 — torch sorts no bool)."""
    order = torch.argsort((~table.valid).to(torch.uint8), stable=True)
    return BindingTable(table.rows[order], table.valid[order], table.overflow)


def set_column(rows: torch.Tensor, col: int, values: torch.Tensor
               ) -> torch.Tensor:
    """``rows`` with column ``col`` replaced — out of place (a clone), as
    the reference's ``.at[:, col].set``."""
    out = rows.clone()
    out[:, col] = values.to(torch.int32)
    return out
