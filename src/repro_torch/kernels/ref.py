"""Plain PyTorch versions of the probe primitives (the CPU path and the
kernels' ground truth).

``repro_torch.kernels.ops`` runs these for tensors on the CPU; on the card
it launches the CUDA kernels, which ``chip_smoke.py`` and the card tests
hold bit-equal to these.  Outputs are exact integers and booleans.

Where the JAX reference gathers with an index that may fall outside the
array (jnp clamps silently), the index is clamped explicitly here, and an
empty array is never indexed: torch raises on an out-of-range gather on
the CPU and faults on the card.
"""

from __future__ import annotations

import math

import torch


def _common(a: torch.Tensor, b: torch.Tensor):
    """Both operands in one integer type (int64 where they differ)."""
    if a.dtype == b.dtype:
        return a, b
    return a.to(torch.int64), b.to(torch.int64)


def sorted_probe_ref(keys: torch.Tensor, queries: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """rank = searchsorted-left; contains = membership (keys sorted asc)."""
    keys, queries = _common(keys, queries)
    rank = torch.searchsorted(keys, queries, side="left", out_int32=True)
    n = keys.shape[0]
    if n == 0:
        return rank, torch.zeros(queries.shape, dtype=torch.bool,
                                 device=queries.device)
    at = keys[rank.clamp(0, n - 1)]
    contains = (rank < n) & (at == queries)
    return rank, contains


def eqrange_ref(sorted_keys: torch.Tensor, query_keys: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query equal range ``[lo, hi)`` in a globally sorted key array
    (int32 positions)."""
    sorted_keys, query_keys = _common(sorted_keys, query_keys)
    lo = torch.searchsorted(sorted_keys, query_keys, side="left",
                            out_int32=True)
    hi = torch.searchsorted(sorted_keys, query_keys, side="right",
                            out_int32=True)
    return lo, hi


def rank_ref(sorted_keys: torch.Tensor, queries: torch.Tensor,
             side: str = "left") -> torch.Tensor:
    """One-sided rank (``searchsorted``) of ``queries`` in a sorted array."""
    sorted_keys, queries = _common(sorted_keys, queries)
    return torch.searchsorted(sorted_keys, queries, side=side,
                              out_int32=True)


def delta_probe_ref(ins_keys: torch.Tensor, tomb_pos: torch.Tensor,
                    query_keys: torch.Tensor, base_lo: torch.Tensor,
                    base_hi: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor,
                               torch.Tensor, torch.Tensor]:
    """The merged base+delta probe's delta half: the equal range of each
    ``query_keys[i]`` in the sorted insert keys, and the tombstone ranks
    of the base run bounds (tombstoned base positions strictly below
    ``base_lo[i]`` / ``base_hi[i]``).  Four int32 tensors
    ``(ins_lo, ins_hi, tomb_lo, tomb_hi)``.

    Pure ``searchsorted``, which gathers nothing: an empty insert or
    tombstone column gives zeros for its pair, and a query key equal to
    the int64 max gets ``ins_hi == m`` (the Pallas wrapper's clamp)."""
    ins_lo, ins_hi = eqrange_ref(ins_keys, query_keys)
    tomb_lo = rank_ref(tomb_pos, base_lo, side="left")
    tomb_hi = rank_ref(tomb_pos, base_hi, side="left")
    return ins_lo, ins_hi, tomb_lo, tomb_hi


def searchsorted_in_runs_ref(values: torch.Tensor, lo: torch.Tensor,
                             hi: torch.Tensor, targets: torch.Tensor,
                             side: str = "left") -> torch.Tensor:
    """Binary search of ``targets[i]`` within ``values[lo[i]:hi[i]]`` (each
    run individually sorted).  Returns absolute insertion positions
    (int32).

    Pure bisection with a fixed iteration count, as the reference does;
    the probe index is clamped into ``[0, n)`` and an empty ``values``
    leaves every position at ``lo``.
    """
    n = values.shape[0]
    lo_ = lo.to(torch.int64)
    hi_ = hi.to(torch.int64)
    if n == 0:
        return lo_.to(torch.int32)
    t = targets.to(torch.int64)
    steps = max(1, math.ceil(math.log2(max(n, 2))) + 1)
    for _ in range(steps):
        mid = (lo_ + hi_) >> 1
        v = values[mid.clamp(0, n - 1)].to(torch.int64)
        go_right = v < t if side == "left" else v <= t
        live = lo_ < hi_
        lo_, hi_ = (torch.where(go_right & live, mid + 1, lo_),
                    torch.where(~go_right & live, mid, hi_))
    return lo_.to(torch.int32)


def run_probe_ref(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                  targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos, contains) of ``targets[i]`` within the sorted run
    ``values[lo[i]:hi[i]]``; an empty run gives ``(lo, False)``."""
    pos = searchsorted_in_runs_ref(values, lo, hi, targets, side="left")
    n = values.shape[0]
    if n == 0:
        return pos, torch.zeros(pos.shape, dtype=torch.bool,
                                device=pos.device)
    at = values[pos.clamp(0, n - 1)].to(torch.int64)
    contains = (pos.to(torch.int64) < hi.to(torch.int64)) \
        & (at == targets.to(torch.int64))
    return pos, contains


def max_run_length_per_segment_ref(sorted_keys: torch.Tensor,
                                   segment_ids: torch.Tensor,
                                   num_segments: int) -> torch.Tensor:
    """Per-segment maximum equal-key run length in a sorted key column.

    ``sorted_keys`` ascending; ``segment_ids`` non-decreasing, each in
    ``[0, num_segments)`` (predicate runs in the PSO/POS layouts guarantee
    both; torch's scatter raises on an id outside, where jax's segment ops
    dropped it).  Returns int64[num_segments]; empty segments get 0 — the
    ``scatter_reduce("amax")`` starts from zeros, which is the reference's
    ``maximum(segment_max, 0)``.
    """
    dev = sorted_keys.device
    n = sorted_keys.shape[0]
    out = torch.zeros(num_segments, dtype=torch.int64, device=dev)
    if n == 0:
        return out
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    run_id = torch.cumsum(is_start.to(torch.int64), 0) - 1
    run_len = torch.zeros(n, dtype=torch.int64, device=dev).scatter_add_(
        0, run_id, torch.ones(n, dtype=torch.int64, device=dev))
    return out.scatter_reduce(0, segment_ids.to(torch.int64), run_len[run_id],
                              reduce="amax", include_self=True)
