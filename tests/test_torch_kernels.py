"""The port's kernel primitives (the probes, the wave fingerprint and the
fragment replay) against the JAX package's Pallas kernels (interpret
mode), jnp oracles and numpy twins, exactly.  The CUDA kernels themselves
are held against these plain versions on the card by
``tests/test_torch_cuda.py``."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from _torch import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.core import fragcache as ref_fragcache
from repro.kernels.delta_probe import delta_probe_pallas
from repro.kernels.fingerprint import fingerprint_rows_pallas
from repro.kernels.owned_probe import eqrange_owned_pallas
from repro.kernels.replay import replay_delta_pallas
from repro.kernels.run_probe import (run_probe_pallas,
                                     run_probe_prefetch_pallas)
from repro.kernels.sorted_probe import sorted_probe_pallas
from repro.rdf.store import _subject_hash
from repro_torch.core import fragcache
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.delta_probe import delta_probe_cuda, delta_probe_plain
from repro_torch.kernels.fingerprint import (fingerprint_rows_cuda,
                                             fingerprint_rows_plain)
from repro_torch.kernels.owned_probe import (eqrange_owned_cuda,
                                             eqrange_owned_plain)
from repro_torch.kernels.replay import replay_delta_cuda, replay_delta_plain
from repro_torch.kernels.run_probe import run_probe_cuda, run_probe_plain
from repro_torch.kernels.sorted_probe import (sorted_probe_cuda,
                                              sorted_probe_plain)

I64_MAX = np.iinfo(np.int64).max


def _t(a, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _np(t):
    return t.cpu().numpy()


def _probe_inputs(rng, n, q, dt):
    keys = np.sort(rng.integers(-3, max(n * 3, 10), n)).astype(dt)
    queries = rng.integers(-5, max(n * 3, 10) + 5, q).astype(dt)
    if q >= 4 and n:
        queries[:4] = [np.iinfo(dt).max, np.iinfo(dt).min, keys[0], keys[-1]]
    return keys, queries


def _check_sorted_probe_cpu(keys, queries):
    """Every view of the port's sorted probe on the CPU against the
    reference's Pallas kernel (interpret mode) and jnp oracles."""
    k, q = _t(keys), _t(queries)
    p_lo, p_hi, p_c = sorted_probe_pallas(jnp.asarray(keys),
                                          jnp.asarray(queries),
                                          interpret=True)
    lo, hi, c = sorted_probe_plain(k, q)
    assert lo.dtype == hi.dtype == torch.int32 and c.dtype == torch.bool
    np.testing.assert_array_equal(_np(lo), np.asarray(p_lo))
    np.testing.assert_array_equal(_np(hi), np.asarray(p_hi))
    np.testing.assert_array_equal(_np(c), np.asarray(p_c))
    e_lo, e_hi = ops.eqrange(k, q)
    r_lo, r_hi = jref.eqrange_ref(jnp.asarray(keys), jnp.asarray(queries))
    np.testing.assert_array_equal(_np(e_lo), np.asarray(r_lo))
    np.testing.assert_array_equal(_np(e_hi), np.asarray(r_hi))
    rank, contains = ops.sorted_probe(k, q)
    w_rank, w_contains = jref.sorted_probe_ref(jnp.asarray(keys),
                                               jnp.asarray(queries))
    np.testing.assert_array_equal(_np(rank), np.asarray(w_rank))
    np.testing.assert_array_equal(_np(contains), np.asarray(w_contains))
    for side in ("left", "right"):
        got = ops.searchsorted(k, q, side=side)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            _np(got), np.asarray(jref.rank_ref(jnp.asarray(keys),
                                               jnp.asarray(queries), side)))


# --------------------------------------------------------------- sorted_probe

@pytest.mark.parametrize("n,q,dt", [
    (1000, 77, np.int32), (4096, 256, np.int64), (131, 512, np.int32),
    (2048, 500, np.int64), (1, 1, np.int32), (10, 300, np.int64),
])
def test_sorted_probe_sweep(n, q, dt):
    rng = np.random.default_rng(n * 7 + q)
    _check_sorted_probe_cpu(*_probe_inputs(rng, n, q, dt))


@pytest.mark.parametrize("dt", [np.int32, np.int64])
@pytest.mark.parametrize("max_in_keys", [False, True])
def test_sorted_probe_dtype_max_query(dt, max_in_keys):
    """A query equal to the dtype max: rank_hi stays <= n and contains
    reflects the real keys only (twin of test_kernels.py's case)."""
    maxv = np.iinfo(dt).max
    keys = np.array([1, 5, 9] + ([maxv] if max_in_keys else []), dt)
    queries = np.array([maxv, 5, maxv - 1], dt)
    _check_sorted_probe_cpu(keys, queries)


def test_sorted_probe_negative_keys_and_unbound_rows():
    """UNBOUND (-1) subjects probe ``p*R - 1``: negative and boundary keys
    must rank exactly."""
    radix = 100
    keys = np.sort(np.array([-7, -1, 0, 0, 3 * radix, 3 * radix + 5,
                             4 * radix - 1], np.int64))
    queries = np.array([3 * radix - 1, -1, -8, 0, 4 * radix - 1, I64_MAX,
                        np.iinfo(np.int64).min], np.int64)
    _check_sorted_probe_cpu(keys, queries)


def test_sorted_probe_empty_keys():
    queries = np.array([-1, 0, 5, I64_MAX], np.int64)
    lo, hi, c = sorted_probe_plain(_t(np.zeros(0, np.int64)), _t(queries))
    assert not _np(lo).any() and not _np(hi).any() and not _np(c).any()
    r, c2 = ops.sorted_probe(_t(np.zeros(0, np.int64)), _t(queries))
    assert not _np(r).any() and not _np(c2).any()
    e_lo, e_hi = jref.eqrange_ref(jnp.zeros(0, jnp.int64),
                                  jnp.asarray(queries))
    np.testing.assert_array_equal(_np(lo), np.asarray(e_lo))
    np.testing.assert_array_equal(_np(hi), np.asarray(e_hi))


# ----------------------------------------------------------------- run_probe

def _check_run_probe_cpu(vals, lo, hi, targets, **tiles):
    """The port's run probe on the CPU against both Pallas variants
    (interpret mode) and the jnp oracle."""
    v, l, h, t = _t(vals), _t(lo.astype(np.int32)), _t(hi.astype(np.int32)), \
        _t(targets)
    pos, c = run_probe_plain(v, l, h, t)
    assert pos.dtype == torch.int32 and c.dtype == torch.bool
    for kernel in (run_probe_pallas, run_probe_prefetch_pallas):
        w_pos, w_c = kernel(jnp.asarray(vals), jnp.asarray(lo),
                            jnp.asarray(hi), jnp.asarray(targets),
                            interpret=True, **tiles)
        np.testing.assert_array_equal(_np(pos), np.asarray(w_pos))
        np.testing.assert_array_equal(_np(c), np.asarray(w_c))
    o_pos, o_c = ops.run_probe(v, l, h, t)
    np.testing.assert_array_equal(_np(o_pos), _np(pos))
    np.testing.assert_array_equal(_np(o_c), _np(c))
    np.testing.assert_array_equal(_np(ops.run_contains(v, l, h, t)), _np(c))
    np.testing.assert_array_equal(
        _np(ops.searchsorted_in_runs(v, l, h, t)),
        np.asarray(jref.searchsorted_in_runs_ref(
            jnp.asarray(vals), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(targets))))
    np.testing.assert_array_equal(
        _np(ref.searchsorted_in_runs_ref(v, l, h, t, side="right")),
        np.asarray(jref.searchsorted_in_runs_ref(
            jnp.asarray(vals), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(targets), side="right")))


def _run_inputs(rng, n, r, vdt, tdt):
    vals = np.sort(rng.integers(0, max(n * 3, 10), n)).astype(vdt)
    lo = rng.integers(0, n + 1, r)
    hi = np.minimum(n, lo + rng.integers(0, n + 1, r))
    targets = rng.integers(-5, max(n * 3, 10) + 5, r).astype(tdt)
    return vals, lo, hi, targets


@pytest.mark.parametrize("n,r,dt", [
    (1000, 77, np.int32), (4096, 300, np.int64), (131, 512, np.int32),
    (2048, 256, np.int64), (1, 1, np.int32), (10, 400, np.int64),
])
def test_run_probe_sweep(n, r, dt):
    rng = np.random.default_rng(n + 3 * r)
    _check_run_probe_cpu(*_run_inputs(rng, n, r, dt, dt))


def test_run_probe_empty_runs():
    rng = np.random.default_rng(1)
    vals = np.sort(rng.integers(0, 50, 64)).astype(np.int32)
    lo = np.array([0, 10, 64, 32], np.int64)
    hi = lo.copy()  # all runs empty
    targets = np.array([0, 25, 49, -1], np.int32)
    _check_run_probe_cpu(vals, lo, hi, targets)
    pos, c = ops.run_probe(_t(vals), _t(lo.astype(np.int32)),
                           _t(hi.astype(np.int32)), _t(targets))
    np.testing.assert_array_equal(_np(pos), lo)  # pos degenerates to lo
    assert not _np(c).any()


def test_run_probe_boundary_runs():
    """Runs touching index 0 and index n, and the full-array run."""
    rng = np.random.default_rng(2)
    n = 300
    vals = np.sort(rng.integers(0, 500, n)).astype(np.int64)
    lo = np.array([0, 0, n - 7, 0, 17], np.int64)
    hi = np.array([5, n, n, n, n], np.int64)
    targets = np.array([vals[0], vals[-1], vals[-1], -10**9, vals[20]],
                       np.int64)
    _check_run_probe_cpu(vals, lo, hi, targets)


def test_run_probe_padding_edges():
    """Max-valued targets at non-tile-multiple shapes."""
    maxv = np.iinfo(np.int32).max
    vals = np.array([1, 5, 9, maxv - 1, maxv], np.int32)
    lo = np.array([0, 0, 3], np.int64)
    hi = np.array([5, 5, 5], np.int64)
    targets = np.array([maxv, maxv - 1, maxv], np.int32)
    _check_run_probe_cpu(vals, lo, hi, targets, r_tile=8, v_tile=4)


@pytest.mark.parametrize("vdt,tdt", [(np.int32, np.int64),
                                     (np.int64, np.int32)])
def test_run_probe_mixed_dtype(vdt, tdt):
    """int32 values probed with int64 targets (and vice versa): the
    narrow dtype's max as a live target must not match anything but
    itself."""
    rng = np.random.default_rng(3)
    n, r = 333, 101
    vals = np.sort(rng.integers(0, 1000, n)).astype(vdt)
    lo = rng.integers(0, n + 1, r)
    hi = np.minimum(n, lo + rng.integers(0, 150, r))
    targets = rng.integers(-5, 1005, r).astype(tdt)
    targets[0] = np.iinfo(np.int32).max
    _check_run_probe_cpu(vals, lo, hi, targets, r_tile=32, v_tile=64)


def test_run_probe_empty_values():
    lo = np.zeros(3, np.int32)
    pos, c = ops.run_probe(_t(np.zeros(0, np.int32)), _t(lo), _t(lo),
                           _t(np.array([0, 1, -1], np.int64)))
    np.testing.assert_array_equal(_np(pos), lo)
    assert not _np(c).any()


# --------------------------------------------------------------- delta_probe

I64_MIN = np.iinfo(np.int64).min


def _check_delta_probe_cpu(ins, tomb, qk, lo, hi):
    """The port's plain delta probe (and ``ops.delta_probe`` on the CPU)
    against the reference's Pallas kernel (interpret mode), its jnp
    oracle and its numpy twin."""
    want = jref.delta_probe_np(ins, tomb, qk, lo, hi)
    j = [jnp.asarray(a) for a in (ins, tomb, qk, lo, hi)]
    others = [jref.delta_probe_ref(*j)]
    if qk.shape[0]:  # the reference's Pallas wrapper takes no empty batch
        others.append(delta_probe_pallas(*j, interpret=True))
    t = [_t(a) for a in (ins, tomb, qk, lo, hi)]
    for got in (delta_probe_plain(*t), ops.delta_probe(*t)):
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and g.shape == w.shape
            np.testing.assert_array_equal(_np(g), w)
    for other in others:
        for o, w in zip(other, want):
            np.testing.assert_array_equal(np.asarray(o), w)


def _delta_inputs(rng, m, t, q, n_base):
    ins = np.sort(rng.integers(0, 1 << 40, m)).astype(np.int64)
    tomb = np.sort(rng.choice(n_base, t, replace=False)).astype(np.int32)
    qk = rng.integers(0, 1 << 40, q).astype(np.int64)
    if m and q:
        qk[:q // 2] = ins[rng.integers(0, m, q // 2)]  # exact hits
    lo = rng.integers(0, n_base + 1, q).astype(np.int32)
    hi = np.minimum(n_base, lo + rng.integers(0, n_base // 2 + 1, q)
                    ).astype(np.int32)
    if q >= 4:
        qk[:4] = [I64_MAX, I64_MIN, -1, 0]
        lo[:4] = [0, n_base, 7, n_base]  # base_lo == base_hi, == n_base
        hi[:4] = [0, n_base, 7, n_base]
    return ins, tomb, qk, lo, hi


@pytest.mark.parametrize("m,t,q", [
    (64, 32, 128), (1000, 700, 513), (1, 1, 9), (0, 40, 100), (50, 0, 100),
    (0, 0, 17), (30, 20, 0), (2048, 2048, 2049),
])
def test_delta_probe_matches_reference(m, t, q):
    rng = np.random.default_rng(m * 31 + t * 7 + q)
    _check_delta_probe_cpu(*_delta_inputs(rng, m, t, q, n_base=5000))


def test_delta_probe_duplicate_insert_keys_and_extremes():
    """Runs of equal insert keys (one (p, s) with many inserted objects),
    the int64 extremes among the keys and queries, and tombstones at
    positions 0 and n_base - 1."""
    n_base = 100
    ins = np.array([I64_MIN, -5, 3, 3, 3, 8, 8, I64_MAX], np.int64)
    tomb = np.array([0, 1, 50, n_base - 1], np.int32)
    qk = np.array([I64_MIN, -5, 3, 4, 8, I64_MAX, I64_MAX - 1, 9], np.int64)
    lo = np.array([0, 0, 1, 2, 50, 99, n_base, 51], np.int32)
    hi = np.array([0, 1, 2, 50, 51, n_base, n_base, 99], np.int32)
    _check_delta_probe_cpu(ins, tomb, qk, lo, hi)


@pytest.mark.parametrize("n,q", [(1000, 300), (1, 5), (2, 8), (4096, 700)])
def test_int32_tombstone_ranks_match_reference(n, q):
    """int32 base positions against an int32 tombstone column — the three
    rank searches of the merged path (``searchsorted`` right over the
    ``adj`` column, left over the positions, ``sorted_probe``) — against
    the reference's kernel and oracles."""
    rng = np.random.default_rng(n + q)
    n_base = 3 * n + 10
    pos = np.sort(rng.choice(n_base, n, replace=False)).astype(np.int32)
    adj = (pos - np.arange(n, dtype=np.int32)).astype(np.int32)
    queries = rng.integers(0, n_base + 1, q).astype(np.int32)
    if n and q >= 3:
        queries[:3] = [pos[0], pos[-1], n_base]
    _check_sorted_probe_cpu(pos, queries)
    _check_sorted_probe_cpu(adj, queries)
    # no tombstones: every rank 0, as the reference's jnp oracles give
    # (its Pallas kernel takes no empty column)
    empty = np.zeros(0, np.int32)
    for side in ("left", "right"):
        got = ops.searchsorted(_t(empty), _t(queries), side=side)
        np.testing.assert_array_equal(_np(got), np.asarray(jref.rank_ref(
            jnp.asarray(empty), jnp.asarray(queries), side)))
    rank, contains = ops.sorted_probe(_t(empty), _t(queries))
    assert not _np(rank).any() and not _np(contains).any()


# ---------------------------------------------------------------- owned probe

_EXTREME_SUBJECTS = np.array(
    [0, 1, -1, 2, 2**31 - 1, 2**31, 2**32 - 1, 2**32, (1 << 62) - 1,
     -(2**31), np.iinfo(np.int64).min, np.iinfo(np.int64).min + 1,
     np.iinfo(np.int64).max - 1, np.iinfo(np.int64).max], np.int64)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 7, 8, 64, 4095, 4096, 10007])
def test_subject_shard_matches_reference(n_shards):
    """The int64 splitmix64 against the reference's uint64 one and the
    store's partitioner, bit for bit, extremes and negatives included."""
    rng = np.random.default_rng(n_shards)
    subjects = np.concatenate([
        rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, 2000,
                     dtype=np.int64),
        rng.integers(0, 1 << 40, 500), _EXTREME_SUBJECTS]).astype(np.int64)
    got = ref.subject_shard_ref(_t(subjects), n_shards)
    assert got.dtype == torch.int32
    want = np.asarray(jref.subject_shard_ref(jnp.asarray(subjects), n_shards))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got), _subject_hash(subjects) % n_shards)


@pytest.mark.parametrize("n_shards,my_shard", [(1, 0), (2, 1), (4, 0),
                                               (4, 3), (8, 5)])
def test_eqrange_owned_matches_reference(n_shards, my_shard):
    """The plain owned probe (and ``ops.eqrange_owned`` on the CPU)
    against the reference's Pallas kernel in interpret mode at its own
    test's cases: a non-owned row gets the empty run ``[lo, lo)``."""
    rng = np.random.default_rng(10 * n_shards + my_shard)
    n, q = 800, 257  # a query count that fills no tile
    keys = np.sort(rng.integers(0, 3000, n)).astype(np.int64)
    queries = rng.integers(-5, 3005, q).astype(np.int64)
    queries[:2] = [I64_MAX, np.iinfo(np.int64).min]
    subjects = rng.integers(0, 1 << 40, q).astype(np.int64)
    subjects[:len(_EXTREME_SUBJECTS)] = _EXTREME_SUBJECTS
    want = eqrange_owned_pallas(jnp.asarray(keys), jnp.asarray(queries),
                                jnp.asarray(subjects), my_shard, n_shards,
                                interpret=True)
    for got in (eqrange_owned_plain(_t(keys), _t(queries), _t(subjects),
                                    my_shard, n_shards),
                ops.eqrange_owned(_t(keys), _t(queries), _t(subjects),
                                  my_shard, n_shards)):
        assert [g.dtype for g in got] == [torch.int32, torch.int32,
                                          torch.bool]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
    owned = _np(got[2])
    assert owned.all() if n_shards == 1 else 0 < owned.sum() < q


def test_eqrange_owned_edges():
    """Empty columns and batches, and shard counts past the reference's
    MAX_SHARDS, against numpy's searchsorted and the store's hash."""
    keys = np.array([-7, 3, 3, 9, I64_MAX], np.int64)
    for n_shards in (1, 5000, 10007):
        for k in (keys, keys[:0]):
            q = np.array([3, I64_MAX, -8, 9, 0], np.int64)
            subj = _EXTREME_SUBJECTS[-5:]
            lo, hi, own = ops.eqrange_owned(_t(k), _t(q), _t(subj), 1,
                                            n_shards)
            owned = _subject_hash(subj) % n_shards == 1
            w_lo = np.searchsorted(k, q, "left")
            w_hi = np.where(owned, np.searchsorted(k, q, "right"), w_lo)
            np.testing.assert_array_equal(_np(own), owned)
            np.testing.assert_array_equal(_np(lo), w_lo)
            np.testing.assert_array_equal(_np(hi), w_hi)
    empty = _t(np.zeros(0, np.int64))
    lo, hi, own = ops.eqrange_owned(_t(keys), empty, empty, 0, 3)
    assert lo.shape == hi.shape == own.shape == (0,)
    with pytest.raises(ValueError, match="n_shards"):
        ops.eqrange_owned(_t(keys), empty, empty, 0, 0)


# ---------------------------------------------------------------- fingerprint

I32 = np.iinfo(np.int32)


def _digest(x):
    return tuple(int(v) for v in np.asarray(x).tolist())


@pytest.mark.parametrize("n,cols,cap", [
    (0, 0, 4), (0, 3, 8), (1, 1, 1), (5, 2, 16),
    (100, 4, 256), (513, 3, 1024), (2048, 6, 2048),
    (7, 0, 16), (0, 2, 0), (1000, 3, 1000),
])
def test_fingerprint_matches_reference(n, cols, cap):
    """The port's plain digest (and ``ops.fingerprint_rows`` on the CPU)
    of a cap-sized table with a valid prefix of ``n`` rows equals the
    reference's Pallas kernel (interpret mode), its jnp oracle and both
    packages' numpy twins of the bare prefix; garbage past the prefix is
    invisible.  The values include -1 (UNBOUND) and the int32 extremes."""
    rng = np.random.default_rng(n * 7 + cols + cap)
    full = rng.integers(I32.min, I32.max, (cap, cols), dtype=np.int64,
                        endpoint=True).astype(np.int32)
    if cols and cap >= 4:
        full[:4, 0] = [-1, I32.max, I32.min, 0]
    valid = np.zeros(cap, bool)
    valid[:n] = True
    want = ref.fingerprint_prefix_np(full[:n])
    assert want == jref.fingerprint_prefix_np(full[:n])
    assert all(0 <= v < 2**32 for v in want)
    assert _digest(jref.fingerprint_rows_ref(jnp.asarray(full),
                                             jnp.asarray(valid))) == want
    if cols and cap:
        assert _digest(fingerprint_rows_pallas(
            jnp.asarray(full), jnp.asarray(valid), r_tile=256,
            interpret=True)) == want
    got = fingerprint_rows_plain(_t(full), _t(valid))
    assert got.dtype == torch.int64 and got.shape == (4,)
    assert _digest(got) == want
    got = ops.fingerprint_rows(_t(full[None]), _t(valid[None]))
    assert got.shape == (1, 4) and _digest(got[0]) == want
    full2 = full.copy()
    full2[n:] = -7
    assert _digest(fingerprint_rows_plain(_t(full2), _t(valid))) == want


def test_fingerprint_non_prefix_mask_and_lane_axis():
    """A mask that is not a prefix, and a wave ``[B, n, C]`` digested in
    one call, each lane equal to the reference's per-lane digest."""
    rng = np.random.default_rng(3)
    rows = rng.integers(-1, 50, (5, 96, 3)).astype(np.int32)
    rows[4, :3, 1] = [I32.min, I32.max, -1]
    valid = np.zeros((5, 96), bool)
    for j, m in enumerate([0, 1, 7, 96]):
        valid[j, :m] = True
    valid[4] = rng.random(96) < 0.5  # not a prefix
    got = ops.fingerprint_rows(_t(rows), _t(valid))
    assert got.shape == (5, 4) and got.dtype == torch.int64
    for j in range(5):
        want = _digest(jref.fingerprint_rows_ref(jnp.asarray(rows[j]),
                                                 jnp.asarray(valid[j])))
        assert _digest(got[j]) == want
        assert _digest(fingerprint_rows_pallas(
            jnp.asarray(rows[j]), jnp.asarray(valid[j]), r_tile=32,
            interpret=True)) == want
        if j < 4:
            assert want == ref.fingerprint_prefix_np(rows[j, :valid[j].sum()])
    empty = ops.fingerprint_rows(_t(rows[:, :, :0]).contiguous(), _t(valid))
    for j in range(5):
        assert _digest(empty[j]) == _digest(jref.fingerprint_rows_ref(
            jnp.asarray(rows[j, :, :0]), jnp.asarray(valid[j])))


def test_mix32_in_int64_matches_uint32():
    """The int64 emulation of the uint32 multiply-and-mix is exact over
    the values that overflow a naive int64 product: all-ones, the int32
    extremes as unsigned, UNBOUND, and random 32-bit words."""
    rng = np.random.default_rng(1)
    vals = np.concatenate([
        np.array([0, 1, 2**32 - 1, 2**31 - 1, 2**31, (-1) & 0xFFFFFFFF,
                  0x85EBCA6B, 0xC2B2AE35], np.uint64),
        rng.integers(0, 2**32, 1000, dtype=np.uint64)])
    got = ref._mix32(torch.from_numpy(vals.astype(np.int64)))
    want = ref._mix32_np(vals.astype(np.uint32))
    np.testing.assert_array_equal(_np(got), want.astype(np.int64))
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B1):
        prod = ref._mul32(torch.from_numpy(vals.astype(np.int64)), c)
        np.testing.assert_array_equal(
            _np(prod), (vals.astype(np.uint32) * np.uint32(c)).astype(
                np.int64))


# ---------------------------------------------------------------- replay delta

@pytest.mark.parametrize("n_in,n_out,cap,n_vars,n_w,m_pad", [
    (1, 0, 8, 1, 0, 1),       # negative fragment: empty delta
    (1, 3, 16, 2, 1, 4),      # fresh-seed expansion
    (5, 5, 32, 3, 0, 8),      # pure filter unit: no write cols
    (7, 19, 64, 4, 2, 32),    # fan-out with two written columns
    (100, 257, 512, 5, 3, 512),
    (3, 16, 16, 1, 1, 16),    # M == cap, V == 1
])
def test_replay_delta_matches_reference(n_in, n_out, cap, n_vars, n_w,
                                        m_pad):
    """The port's plain replay (and ``ops.replay_delta`` on the CPU)
    equals the reference's Pallas kernel (interpret mode), its jnp
    oracle and both packages' numpy twins ``fragcache.replay``, padded
    delta widths and UNBOUND dead regions included."""
    rng = np.random.default_rng(n_in + 3 * n_out + cap)
    write_cols = tuple(range(n_vars - 1, n_vars - 1 - n_w, -1))
    seed = np.full((cap, n_vars), -1, np.int32)
    seed[:n_in] = rng.integers(0, 1000, (n_in, n_vars)).astype(np.int32)
    src = rng.integers(0, n_in, n_out).astype(np.int32)
    written = rng.integers(0, 1000, (n_out, n_w)).astype(np.int32)
    entry = fragcache.FragmentEntry(src, written, False, 0)
    want_rows, want_valid = fragcache.replay(entry, seed[:n_in], cap,
                                             n_vars, write_cols)
    twin = ref_fragcache.replay(
        ref_fragcache.FragmentEntry(src, written, False, 0), seed[:n_in],
        cap, n_vars, write_cols)
    np.testing.assert_array_equal(twin[0], want_rows)
    src_p = np.zeros((m_pad,), np.int32)
    src_p[:n_out] = src
    wr_p = np.zeros((m_pad, n_w), np.int32)
    wr_p[:n_out] = written
    j = (jnp.asarray(seed), jnp.asarray(src_p), jnp.asarray(wr_p),
         jnp.int32(n_out))
    for other in (jref.replay_delta_ref(*j, write_cols),
                  replay_delta_pallas(*j, write_cols=write_cols, j_tile=16,
                                      i_tile=32, interpret=True)):
        np.testing.assert_array_equal(np.asarray(other[0]), want_rows)
        np.testing.assert_array_equal(np.asarray(other[1]), want_valid)
    n = torch.tensor(n_out, dtype=torch.int32)
    rows, valid = replay_delta_plain(_t(seed), _t(src_p), _t(wr_p), n,
                                     write_cols)
    assert rows.dtype == torch.int32 and valid.dtype == torch.bool
    np.testing.assert_array_equal(_np(rows), want_rows)
    np.testing.assert_array_equal(_np(valid), want_valid)
    rows, valid = ops.replay_delta(_t(seed[None]), _t(src_p[None]),
                                   _t(wr_p[None]), n[None], write_cols)
    np.testing.assert_array_equal(_np(rows[0]), want_rows)
    np.testing.assert_array_equal(_np(valid[0]), want_valid)


def test_replay_delta_lane_axis_and_clamp():
    """A wave replayed in one call equals each lane replayed alone, lanes
    with ``n_out == 0`` come out empty, ``n_out`` past ``M`` leaves valid
    UNBOUND rows, and a source row past the table is clamped as the
    reference's gather clamps it.  (A negative source row is outside the
    function's domain: the reference's jnp gather wraps it and its Pallas
    kernel matches nothing; the scheduler's provenance rows are never
    negative.)"""
    rng = np.random.default_rng(4)
    b, cap, n_vars, m = 4, 32, 3, 16
    seed = rng.integers(0, 100, (b, cap, n_vars)).astype(np.int32)
    src = rng.integers(0, cap, (b, m)).astype(np.int32)
    src[2, :3] = [cap, cap + 100, cap - 1]
    written = rng.integers(0, 100, (b, m, 1)).astype(np.int32)
    n_out = np.array([0, 5, 16, 20], np.int32)
    rows, valid = ops.replay_delta(_t(seed), _t(src), _t(written),
                                   _t(n_out), (1,))
    assert rows.shape == (b, cap, n_vars) and valid.shape == (b, cap)
    for lane in range(b):
        want = jref.replay_delta_ref(
            jnp.asarray(seed[lane]), jnp.asarray(src[lane]),
            jnp.asarray(written[lane]), jnp.int32(n_out[lane]), (1,))
        np.testing.assert_array_equal(_np(rows[lane]), np.asarray(want[0]))
        np.testing.assert_array_equal(_np(valid[lane]), np.asarray(want[1]))
    assert not _np(valid[0]).any() and (_np(rows[0]) == -1).all()


# ------------------------------------------------------- the rest of the seam

def test_max_run_length_per_segment_matches_reference(watdiv_small):
    _, store = watdiv_small
    n_seg = store.n_predicates + 1
    for keys in (store.h_key_ps, store.h_key_po):
        seg = keys // store.radix
        want = np.asarray(jref.max_run_length_per_segment_ref(
            jnp.asarray(keys), jnp.asarray(seg), n_seg))
        got = ops.max_run_length_per_segment(_t(keys), _t(seg), n_seg)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(_np(got), want)
    empty = ops.max_run_length_per_segment(_t(np.zeros(0, np.int64)),
                                           _t(np.zeros(0, np.int64)), 3)
    np.testing.assert_array_equal(_np(empty), [0, 0, 0])


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000, 4882, 10_018_031])
def test_probe_op_cost_matches_reference(n):
    assert ref_ops._use_pallas() is False  # the reference's jnp path
    assert ops.probe_op_cost(n) == ref_ops.probe_op_cost(n)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    before = dict(ops.LAUNCHES)
    keys = _t(np.arange(10, dtype=np.int64))
    ops.eqrange(keys, keys)
    ops.eqrange_owned(keys, keys, keys, 1, 4)
    ops.searchsorted(keys, keys, side="right")
    ops.run_probe(keys.to(torch.int32), _t(np.zeros(10, np.int32)),
                  _t(np.full(10, 10, np.int32)), keys)
    bounds = _t(np.zeros(10, np.int32))
    ops.delta_probe(keys, bounds, keys, bounds, bounds)
    ops.sorted_probe(bounds, bounds)
    block = torch.zeros((2, 10, 0), dtype=torch.int32)
    ops.fingerprint_rows(block, torch.ones((2, 10), dtype=torch.bool))
    ops.replay_delta(torch.zeros((2, 10, 1), dtype=torch.int32),
                     torch.zeros((2, 4), dtype=torch.int32),
                     torch.zeros((2, 4, 0), dtype=torch.int32),
                     torch.zeros(2, dtype=torch.int32), ())
    assert ops.LAUNCHES == before


def test_other_devices_raise():
    keys = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.eqrange(keys, keys)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.run_probe(keys, keys, keys, keys)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.delta_probe(keys, keys, keys, keys, keys)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.eqrange_owned(keys, keys, keys, 0, 2)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.fingerprint_rows(keys.reshape(1, 2, 2).to(torch.int32),
                             keys[None, :2].to(torch.bool))
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.replay_delta(keys.reshape(1, 4, 1), keys[:1], keys[:1],
                         keys[:1], ())
    with pytest.raises(ValueError, match="side"):
        ops.searchsorted(keys, keys, side="middle")


def test_kernel_wrappers_reject_cpu_tensors():
    k = _t(np.arange(4, dtype=np.int64))
    with pytest.raises(ValueError, match="CUDA device"):
        sorted_probe_cuda(k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        run_probe_cuda(k, k.to(torch.int32), k.to(torch.int32), k)
    b = k.to(torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        delta_probe_cuda(k, b, k, b, b)
    with pytest.raises(ValueError, match="CUDA device"):
        eqrange_owned_cuda(k, k, k, 0, 2)
    with pytest.raises(ValueError, match="CUDA device"):
        fingerprint_rows_cuda(b.reshape(1, 2, 2), b[None, :2].to(torch.bool))
    with pytest.raises(ValueError, match="CUDA device"):
        replay_delta_cuda(b.reshape(1, 4, 1), b[None, :2], b[None, :2, None],
                          b[:1], (0,))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("sorted_probe")


def test_build_key_follows_the_source(monkeypatch, tmp_path):
    for name in _build.KERNELS:
        shutil.copy(_build.CSRC / f"{name}.cu", tmp_path / f"{name}.cu")
    shutil.copy(_build.CSRC / "bisect.cuh", tmp_path / "bisect.cuh")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("run_probe")
    assert before.parent == _build.BUILD_DIR and before.suffix == ".so"
    assert before == _build.library_path("run_probe")
    with open(tmp_path / "run_probe.cu", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("run_probe") != before
    assert _build.library_path("sorted_probe").name.startswith("sorted_probe-")
    # the shared bisection header is part of every kernel's key
    before = _build.library_path("delta_probe")
    with open(tmp_path / "bisect.cuh", "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path("delta_probe") != before
