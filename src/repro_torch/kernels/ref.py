"""Plain PyTorch versions of the kernel primitives — the probes, the
wave fingerprint, the fragment replay and attention (the CPU path and the
kernels' ground truth).

``repro_torch.kernels.ops`` runs these for tensors on the CPU; on the card
it launches the CUDA kernels, which ``chip_smoke.py`` and the card tests
hold bit-equal to these.  Outputs are exact integers and booleans, except
attention's, which is float and held to these within a tolerance.

Where the JAX reference gathers with an index that may fall outside the
array (jnp clamps silently), the index is clamped explicitly here, and an
empty array is never indexed: torch raises on an out-of-range gather on
the CPU and faults on the card.
"""

from __future__ import annotations

import math

import numpy as np
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


# splitmix64's finaliser constants as the int64 values of their uint64 bits
_SM64_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_SM64_M2 = 0x94D049BB133111EB - (1 << 64)


def _shr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (``>>`` on int64 is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def subject_shard_ref(subjects: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Owning shard of each subject id: the splitmix64 finaliser of its
    64 bits, bit 63 masked, mod ``n_shards`` (int32) — bit-equal to the
    reference's uint64 ``subject_shard_ref`` and to the store's
    partitioner ``rdf.store._subject_hash``.

    torch on the CPU has no uint64 ``>>`` or ``%``, so the hash runs in
    int64: logical shifts are masked arithmetic ones, the multiplies wrap
    mod 2^64 as uint64's do, and after the bit-63 mask the value is
    non-negative, so ``%`` is the unsigned remainder."""
    x = subjects.to(torch.int64)
    x = (x ^ _shr64(x, 30)) * _SM64_M1
    x = (x ^ _shr64(x, 27)) * _SM64_M2
    x = x ^ _shr64(x, 31)
    return ((x & 0x7FFFFFFFFFFFFFFF) % n_shards).to(torch.int32)


def eqrange_owned_ref(sorted_keys: torch.Tensor, query_keys: torch.Tensor,
                      subjects: torch.Tensor, my_shard: int, n_shards: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``eqrange`` masked by subject ownership: ``(lo, hi, owned)`` with
    ``hi = lo`` (the empty run) on every row whose subject does not hash
    to ``my_shard`` — the reference's masking path, ``ops._rf``."""
    owned = subject_shard_ref(subjects, n_shards) == my_shard
    lo, hi = eqrange_ref(sorted_keys, query_keys)
    return lo, torch.where(owned, hi, lo), owned


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


# --------------------------------------------------------------------------
# request fingerprints (the scheduler's digest-first cache keys)
# --------------------------------------------------------------------------
#
# The hash is defined in wrapping uint32 arithmetic so that this plain
# version, the CUDA kernel and the numpy host twin give identical bit
# patterns, equal to the JAX reference's:
#
#     h_i   = fold over columns c of mix32(h ^ (v[i, c] + (c+1)*COL))
#     g_i   = mix32(h_i ^ mix32((i+1) * POS))        position-dependent
#     acc_s = sum_{valid i} mix32(g_i + SALT_s)       (mod 2^32, s = 0..3)
#     out_s = mix32(acc_s ^ (n_valid * POS + SALT_s))
#
# Only valid rows contribute, so the digest of a table whose invalid
# region holds step garbage equals the digest of its valid prefix.
#
# torch on the CPU has no uint32 arithmetic, so the plain version holds
# every uint32 value in an int64 and masks with 0xFFFFFFFF after each
# step.  A 32-bit value times a 32-bit constant overflows int64, so
# ``_mul32`` splits the constant into 16-bit halves: every partial
# product stays below 2^48.

_M32 = 0xFFFFFFFF
_FP_SEED = 0x9E3779B9
_FP_COL = 0x85EBCA6B
_FP_POS = 0x9E3779B1
_FP_SALTS = (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in ``[0, 2^32)``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def fingerprint_rows_ref(block: torch.Tensor, valid: torch.Tensor
                         ) -> torch.Tensor:
    """The 4 x uint32 digest of the valid rows of ``block``.

    ``block`` is ``int32[n, C]`` with ``valid`` ``bool[n]``, or carries a
    leading lane axis (``[B, n, C]`` and ``[B, n]``, one digest per
    lane).  Returns int64 ``[4]`` (or ``[B, 4]``) holding the unsigned
    values — the same integers as the reference's uint32 digest.
    """
    n, n_cols = block.shape[-2], block.shape[-1]
    dev = block.device
    v = block.to(torch.int64) & _M32
    h = torch.full(block.shape[:-1], _FP_SEED, dtype=torch.int64,
                   device=dev)
    for c in range(n_cols):
        col = ((c + 1) * _FP_COL) & _M32
        h = _mix32(h ^ ((v[..., c] + col) & _M32))
    pos = _mul32(torch.arange(1, n + 1, dtype=torch.int64, device=dev)
                 & _M32, _FP_POS)
    g = _mix32(h ^ _mix32(pos))
    m = valid.to(torch.int64)
    n_in = m.sum(-1) & _M32
    outs = []
    for s in _FP_SALTS:
        acc = (_mix32((g + s) & _M32) * m).sum(-1) & _M32
        outs.append(_mix32(acc ^ ((_mul32(n_in, _FP_POS) + s) & _M32)))
    return torch.stack(outs, -1)


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    x = x ^ (x >> np.uint32(16))
    return x


def fingerprint_prefix_np(block: np.ndarray) -> tuple[int, int, int, int]:
    """Host twin of ``fingerprint_rows_ref`` for an all-valid prefix block.

    ``block`` is the valid prefix ``int32[n, C]`` (every row valid, in
    order).  Bit-identical to the digest of a table whose valid prefix is
    exactly ``block``; returns Python ints, as the reference does.
    """
    block = np.ascontiguousarray(block, dtype=np.int32)
    n, n_cols = block.shape
    h = np.full((n,), _FP_SEED, np.uint32)
    for c in range(n_cols):
        v = block[:, c].astype(np.uint32)
        h = _mix32_np(h ^ (v + np.uint32(((c + 1) * _FP_COL) & _M32)))
    pos = (np.arange(n, dtype=np.uint32) + np.uint32(1)) * np.uint32(_FP_POS)
    g = _mix32_np(h ^ _mix32_np(pos))
    accs = np.array(
        [np.sum(_mix32_np(g + np.uint32(s)), dtype=np.uint32) if n else 0
         for s in _FP_SALTS], np.uint32)
    fins = np.array([(n * _FP_POS + s) & _M32 for s in _FP_SALTS], np.uint32)
    # 1-D arrays throughout: numpy warns on uint32 wrap-around for
    # scalar operands but not for arrays
    out = _mix32_np(accs ^ fins)
    return tuple(int(x) for x in out)


# --------------------------------------------------------------------------
# fragment replay (the scheduler's device-side cache-hit path)
# --------------------------------------------------------------------------

def replay_delta_ref(seed_rows: torch.Tensor, src: torch.Tensor,
                     written: torch.Tensor, n_out: torch.Tensor,
                     write_cols: tuple[int, ...]
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter a cached fragment delta onto a lane's seed prefix.

    ``seed_rows`` is the lane's full-capacity table ``int32[cap, V]``
    whose valid prefix is the unit's input; ``src`` the delta's source
    rows ``int32[M]`` (``M <= cap``; entries past ``n_out`` are padding),
    ``written`` the values for ``write_cols`` ``int32[M, W]``, ``n_out``
    the true output row count.  Every argument may carry a leading lane
    axis (``[B, cap, V]``, ``[B, M]``, ``[B, M, W]``, ``[B]``).  Returns
    the replayed ``(rows, valid)`` at full capacity, the dead region
    UNBOUND: row ``j < n_out`` is ``seed_rows[src[j]]`` with the write
    columns overwritten by ``written[j]``.  The reference's gather clamps
    an out-of-range ``src``; here the clamp is explicit.
    """
    lanes = seed_rows.dim() == 3
    if not lanes:
        seed_rows, src, written = seed_rows[None], src[None], written[None]
        n_out = torch.as_tensor(n_out).reshape(1)
    dev = seed_rows.device
    b, cap, n_vars = seed_rows.shape
    m = src.shape[1]
    n_out = n_out.to(device=dev, dtype=torch.int64)
    live = torch.arange(m, device=dev)[None, :] < n_out[:, None]
    take = torch.where(live, src.to(torch.int64), 0).clamp(0, max(cap - 1, 0))
    lane = torch.arange(b, device=dev)[:, None]
    out = seed_rows[lane, take]
    for w, c in enumerate(write_cols):
        out[:, :, c] = written[:, :, w]
    out = torch.where(live[:, :, None], out, -1)
    rows = torch.full((b, cap, n_vars), -1, dtype=torch.int32, device=dev)
    rows[:, :m] = out
    valid = torch.arange(cap, device=dev)[None, :] < n_out[:, None]
    if not lanes:
        return rows[0], valid[0]
    return rows, valid


# --------------------------------------------------------------------------
# attention (the model stack's one kernel)
# --------------------------------------------------------------------------

def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None
                  ) -> torch.Tensor:
    """Dense attention with GQA head-group broadcast, in float32.

    q ``[B, Hq, Sq, D]``; k, v ``[B, Hkv, Sk, D]`` -> ``[B, Hq, Sq, D]`` in
    q's dtype.  Query head ``h`` reads KV head ``h // (Hq // Hkv)``; the
    causal mask is top-left aligned (``qi >= kj``, also when Sq != Sk),
    masked scores are ``-1e30`` and the denominator is clamped at
    ``1e-30``, as in the JAX reference.
    """
    _, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, -1e30)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vv.float())
    return out.to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale: float | None = None,
                      block_k: int = 1024) -> torch.Tensor:
    """``attention_ref`` computed flash-style: an online softmax over KV
    blocks of ``block_k`` keys, never holding the ``[Sq, Sk]`` scores.

    The reference's ``lax.scan`` over blocks is a loop here; the keys are
    padded to a whole block and the padding masked, as there.
    """
    b, hq, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (dh ** 0.5)
    qg = q.reshape(b, hkv, group, sq, dh).float()
    qpos = torch.arange(sq, device=q.device)
    m = torch.full((b, hkv, group, sq), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, group, sq, dh), dtype=torch.float32,
                      device=q.device)
    for j0 in range(0, sk, block_k):
        kj = k[:, :, j0:j0 + block_k].float()
        vj = v[:, :, j0:j0 + block_k].float()
        pad = block_k - kj.shape[2]
        if pad:
            kj = torch.nn.functional.pad(kj, (0, 0, 0, pad))
            vj = torch.nn.functional.pad(vj, (0, 0, 0, pad))
        s = torch.einsum("bkgqd,bksd->bkgqs", qg, kj) * scale
        kpos = j0 + torch.arange(block_k, device=q.device)
        mask = (kpos < sk)[None, :]
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgqs,bksd->bkgqd", p,
                                                    vj)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(b, hq, sq, dh).to(q.dtype)
