"""The port's probe primitives against the JAX package's Pallas kernels
(interpret mode) and jnp oracles, exactly.  The CUDA kernels themselves
are held against these plain versions on the card by
``tests/test_torch_cuda.py``."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest

from _torch import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as jref
from repro.kernels.delta_probe import delta_probe_pallas
from repro.kernels.run_probe import (run_probe_pallas,
                                     run_probe_prefetch_pallas)
from repro.kernels.sorted_probe import sorted_probe_pallas
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.delta_probe import delta_probe_cuda, delta_probe_plain
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
    ops.searchsorted(keys, keys, side="right")
    ops.run_probe(keys.to(torch.int32), _t(np.zeros(10, np.int32)),
                  _t(np.full(10, 10, np.int32)), keys)
    bounds = _t(np.zeros(10, np.int32))
    ops.delta_probe(keys, bounds, keys, bounds, bounds)
    ops.sorted_probe(bounds, bounds)
    assert ops.LAUNCHES == before


def test_other_devices_raise():
    keys = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.eqrange(keys, keys)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.run_probe(keys, keys, keys, keys)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        ops.delta_probe(keys, keys, keys, keys, keys)
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
