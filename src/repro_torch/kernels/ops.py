"""The kernel dispatch layer: every kernel primitive of the engine and the
model stack, one seam.

The query engine (``core/server.py``, ``core/bindings.py``), the capacity
planner, the scheduler's wave steps (``core/stepper.py``) and the
transformer's attention (``models/layers.py``) route their primitives
through these wrappers; nothing above this layer names a kernel or picks
a path.

Dispatch policy
---------------
By the device of the tensors, and nothing else: tensors on a CUDA device
launch the hand-written CUDA kernel, tensors on the CPU run the plain
PyTorch version (``repro_torch.kernels.ref``).  Any other device raises.
There is no override switch, no small-batch cutoff and no fallback: on
the card a failed build or launch raises to the caller; a zero-column
digest block is a kernel launch too.  The kernels take the widths their
callers pass — int64 keys and queries (and int32 tombstone positions with
int32 queries), int32 or int64 run values with int64 targets, int64
insert keys with int32 tombstone positions, int32 tables with bool
validity and int32 deltas, float32 or bfloat16 attention operands — and
raise on any other.

Launches are counted in ``LAUNCHES`` (``LAUNCHES["sorted_probe"]``,
``["run_probe"]``, ``["delta_probe"]``, ``["eqrange_owned"]``,
``["fingerprint_rows"]``, ``["replay_delta"]``, ``["flash_attention"]``,
``["flash_attention_wgmma"]``), one per kernel launch; the CPU path never
touches them.

Join/probe primitives (the SPF server's hot path)
-------------------------------------------------
- ``eqrange``             — per-query equal range in a sorted key column
                            (the sorted-probe kernel, both rank sides).
- ``sorted_probe``        — rank-left + membership in one sorted array
                            (the same kernel).
- ``searchsorted``        — one-sided rank in one sorted array (the same
                            kernel; the ragged expansion's cumulative-
                            degree bookkeeping in ``core/bindings.py``
                            and the merged path's tombstone ranks).
- ``run_probe``           — rank + membership of targets within per-row
                            sorted runs (the run-probe kernel).
- ``run_contains``        — membership-only view of ``run_probe``.
- ``searchsorted_in_runs`` — rank-only view of ``run_probe``.
- ``delta_probe``         — the merged base+delta probe's delta half:
                            insert-key equal range + tombstone ranks of
                            the base run bounds, one pass (the delta-probe
                            kernel).
- ``eqrange_owned``       — ``eqrange`` on one shard of a subject-hash
                            sharded store, masked by subject ownership:
                            non-owned rows get the empty run (the
                            owner-masked probe kernel).

Scheduler primitives (the fragment cache's device half)
-------------------------------------------------------
- ``fingerprint_rows``    — 4 x uint32 digest of each lane's valid rows
                            (the wave-fingerprint kernel), as int64
                            holding the unsigned values: the cache keys'
                            Omega digests (host twin
                            ``ref.fingerprint_prefix_np``).
- ``replay_delta``        — scatter cached fragment deltas onto the
                            lanes' seed tables (the replay kernel; host
                            twin ``fragcache.replay``), so all-hit waves
                            never pull tables to the host.

Model-stack primitives
----------------------
- ``attention``           — attention forward with GQA and an optional
                            causal mask (the flash-attention kernels:
                            ``flash_attention_cuda`` takes the wgmma kernel
                            for bf16 operands ``wgmma_eligible`` admits,
                            the simple kernel for the rest).  The CPU path is the JAX reference's non-TPU split
                            (``ref.attention_chunked`` for ``Sk >= 2048``,
                            else ``ref.attention_ref``), so it equals the
                            reference's CPU path; the kernel agrees with it
                            within float tolerance, not bit for bit.

Host-side helpers
-----------------
- ``max_run_length_per_segment`` — per-predicate max equal-key run
                            length (the capacity planner's degree oracle;
                            plain torch on every device — once per store
                            epoch, no kernel).
- ``probe_op_cost``       — host-side cost model of one point probe (the
                            TPF page-accounting charge).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import LAUNCHES  # noqa: F401  (re-exported)
from repro_torch.kernels.delta_probe import delta_probe_cuda
from repro_torch.kernels.fingerprint import fingerprint_rows_cuda
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.owned_probe import eqrange_owned_cuda
from repro_torch.kernels.replay import replay_delta_cuda
from repro_torch.kernels.run_probe import run_probe_cuda
from repro_torch.kernels.sorted_probe import sorted_probe_cuda


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"kernel primitives run on CUDA or the CPU, not on "
                     f"{t.device}")


# --------------------------------------------------------------------------
# join/probe primitives
# --------------------------------------------------------------------------

def sorted_probe(keys: torch.Tensor, queries: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rank, contains) of each query in a sorted key array."""
    if _on_card(keys):
        rank_lo, _, contains = sorted_probe_cuda(keys, queries)
        return rank_lo, contains
    return ref.sorted_probe_ref(keys, queries)


def eqrange(sorted_keys: torch.Tensor, query_keys: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query equal range ``[lo, hi)`` in a globally sorted key array,
    as int32 positions on both paths (identical bit patterns).  The
    2-query predicate-bound lookup of ``scan_ovar_free`` takes the kernel
    too: on the card every probe does."""
    if _on_card(sorted_keys):
        rank_lo, rank_hi, _ = sorted_probe_cuda(sorted_keys, query_keys)
        return rank_lo, rank_hi
    return ref.eqrange_ref(sorted_keys, query_keys)


def eqrange_owned(sorted_keys: torch.Tensor, query_keys: torch.Tensor,
                  subjects: torch.Tensor, my_shard: int, n_shards: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``eqrange`` with subject-ownership masking folded into the probe:
    ``(lo, hi, owned)``, int32, int32 and bool.  On a subject-hash-sharded
    store a bound-subject row matches only on the shard its subject
    hashes to (``ref.subject_shard_ref(subjects, n_shards)``), so a row
    that ``my_shard`` does not own gets the empty run ``[lo, lo)`` and
    downstream filters and expansions skip it with no mask pass.
    ``owned`` lets the cost account count only the rows this shard
    probed."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if _on_card(sorted_keys):
        return eqrange_owned_cuda(sorted_keys, query_keys, subjects,
                                  my_shard, n_shards)
    return ref.eqrange_owned_ref(sorted_keys, query_keys, subjects,
                                 my_shard, n_shards)


def searchsorted(sorted_keys: torch.Tensor, queries: torch.Tensor,
                 side: str = "left") -> torch.Tensor:
    """One-sided rank of ``queries`` in a sorted array (int32 positions)."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if _on_card(sorted_keys):
        rank_lo, rank_hi, _ = sorted_probe_cuda(sorted_keys, queries)
        return rank_lo if side == "left" else rank_hi
    return ref.rank_ref(sorted_keys, queries, side=side)


def run_probe(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              targets: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos, contains) of ``targets[i]`` within the sorted run
    ``values[lo[i]:hi[i]]``; ``pos`` is the absolute "left" insertion
    point."""
    if _on_card(values):
        return run_probe_cuda(values, lo, hi, targets)
    return ref.run_probe_ref(values, lo, hi, targets)


def run_contains(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 targets: torch.Tensor) -> torch.Tensor:
    """Membership of ``targets[i]`` in the sorted run ``values[lo[i]:hi[i]]``."""
    return run_probe(values, lo, hi, targets)[1]


def searchsorted_in_runs(values: torch.Tensor, lo: torch.Tensor,
                         hi: torch.Tensor, targets: torch.Tensor
                         ) -> torch.Tensor:
    """Absolute "left" insertion position of ``targets[i]`` within the
    sorted run ``values[lo[i]:hi[i]]``."""
    return run_probe(values, lo, hi, targets)[0]


def delta_probe(ins_keys: torch.Tensor, tomb_pos: torch.Tensor,
                query_keys: torch.Tensor, base_lo: torch.Tensor,
                base_hi: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """``(ins_lo, ins_hi, tomb_lo, tomb_hi)``: the equal range of each
    probe key in the sorted insert keys, and the number of tombstoned
    base positions strictly below each base run bound — the delta half of
    every merged base+delta probe (int32 on both paths)."""
    if _on_card(ins_keys):
        return delta_probe_cuda(ins_keys, tomb_pos, query_keys, base_lo,
                                base_hi)
    return ref.delta_probe_ref(ins_keys, tomb_pos, query_keys, base_lo,
                               base_hi)


# --------------------------------------------------------------------------
# scheduler primitives
# --------------------------------------------------------------------------

def fingerprint_rows(block: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """4 x uint32 digest of each lane's valid rows of a wave ``block``
    (``int32[B, n, C]`` with ``bool[B, n]``), as int64 ``[B, 4]`` holding
    the unsigned values — bit-equal to the host twin
    ``ref.fingerprint_prefix_np`` of each valid prefix."""
    if _on_card(block):
        return fingerprint_rows_cuda(block, valid)
    return ref.fingerprint_rows_ref(block, valid)


def replay_delta(seed_rows: torch.Tensor, src: torch.Tensor,
                 written: torch.Tensor, n_out: torch.Tensor,
                 write_cols: tuple[int, ...]
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Replay cached fragment deltas onto a wave's seed tables
    (``[B, cap, V]``): the full-capacity ``(rows, valid)`` whose valid
    prefix is ``seed_rows[src[:n_out]]`` with ``write_cols`` overwritten
    by ``written`` — bit-equal on the valid prefix to the host twin
    ``fragcache.replay``."""
    if _on_card(seed_rows):
        return replay_delta_cuda(seed_rows, src, written, n_out, write_cols)
    return ref.replay_delta_ref(seed_rows, src, written, n_out, write_cols)


# --------------------------------------------------------------------------
# model-stack primitives
# --------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, scale: float | None = None
              ) -> torch.Tensor:
    """Attention with GQA support: q ``[B, Hq, Sq, D]``, k and v
    ``[B, Hkv, Sk, D]`` -> ``[B, Hq, Sq, D]`` in q's dtype."""
    if _on_card(q):
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    return flash_attention_plain(q, k, v, causal=causal, scale=scale)


def probe_op_cost(n: int) -> int:
    """Per-probe op count of a point probe against a sorted column of
    length ``n`` — the TPF page-accounting cost model.

    Both kernels and the plain path bisect, so every device charges the
    two-sided binary search, ``2 * ceil(log2 n)`` dependent steps: the
    same value the JAX reference charges on its jnp path, which keeps TPF
    ``server_ops`` identical to it.
    """
    return 2 * max(1, math.ceil(math.log2(max(int(n), 2))))


def max_run_length_per_segment(sorted_keys: torch.Tensor,
                               segment_ids: torch.Tensor,
                               num_segments: int) -> torch.Tensor:
    """Per-segment max equal-key run length in a sorted key column.

    The capacity planner's degree oracle: over the PSO key column this is
    each predicate's max subject out-degree, over POS its max object
    in-degree.  Runs once per store epoch, so every device uses the plain
    torch version — there is no hot path to accelerate.
    """
    return ref.max_run_length_per_segment_ref(sorted_keys, segment_ids,
                                              num_segments)
