"""The port's binding-table machinery against the JAX package's:
``unit_table``, ``expand``, ``compact`` and ``set_column`` (exact), plus
twins of ``tests/test_bindings.py``'s probe cases."""

import jax.numpy as jnp
import numpy as np
import pytest

from _hyp import given, settings, st
from _torch import torch

from repro.core import bindings as ref_bindings
from repro_torch.core import bindings
from repro_torch.kernels import ops


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_expansion_equal(lo, hi, valid, cap):
    want = ref_bindings.expand(jnp.asarray(lo), jnp.asarray(hi),
                               jnp.asarray(valid), cap)
    got = bindings.expand(_t(lo), _t(hi), _t(valid), cap)
    for name in bindings.Expansion._fields:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert w.dtype == g.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_expand_basic():
    lo = np.array([0, 4, 10], np.int64)
    hi = np.array([2, 4, 13], np.int64)
    valid = np.array([True, True, True])
    ex = bindings.expand(_t(lo), _t(hi), _t(valid), cap=8)
    assert int(ex.total) == 5
    np.testing.assert_array_equal(ex.src_row.numpy()[:5], [0, 0, 2, 2, 2])
    np.testing.assert_array_equal(ex.flat_idx.numpy()[:5], [0, 1, 10, 11, 12])
    assert int(ex.valid.sum()) == 5
    _assert_expansion_equal(lo, hi, valid, 8)


def test_expand_invalid_rows_contribute_nothing():
    lo = np.array([0, 4], np.int64)
    hi = np.array([3, 6], np.int64)
    valid = np.array([False, True])
    ex = bindings.expand(_t(lo), _t(hi), _t(valid), cap=4)
    assert int(ex.total) == 2
    np.testing.assert_array_equal(ex.src_row.numpy()[:2], [1, 1])
    np.testing.assert_array_equal(ex.flat_idx.numpy()[:2], [4, 5])
    _assert_expansion_equal(lo, hi, valid, 4)


def test_expand_overflow_clamps_to_cap():
    lo, hi = np.array([0], np.int64), np.array([10], np.int64)
    valid = np.array([True])
    ex = bindings.expand(_t(lo), _t(hi), _t(valid), cap=4)
    assert int(ex.total) == 10  # true total, unclamped
    assert int(ex.valid.sum()) == 4  # output rows clamp to cap
    _assert_expansion_equal(lo, hi, valid, 4)


@pytest.mark.parametrize("seed,rows,cap,dt", [
    (0, 40, 128, np.int64), (1, 40, 16, np.int32), (2, 300, 512, np.int32),
    (3, 1, 4, np.int64), (4, 64, 1, np.int32),
])
def test_expand_matches_reference(seed, rows, cap, dt):
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 50, rows).astype(dt)
    hi = (lo + rng.integers(0, 6, rows)).astype(dt)
    valid = rng.random(rows) > 0.3
    _assert_expansion_equal(lo, hi, valid, cap)


@given(st.data())
@settings(max_examples=25, deadline=None)
def test_expand_property(data):
    # few distinct shapes: each new one compiles the reference's jnp ops
    rows = data.draw(st.sampled_from([1, 7, 40]))
    cap = data.draw(st.sampled_from([1, 16, 64]))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**31)))
    lo = rng.integers(0, 30, rows).astype(np.int32)
    hi = (lo + rng.integers(0, 5, rows)).astype(np.int32)
    _assert_expansion_equal(lo, hi, rng.random(rows) > 0.4, cap)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_matches_reference(seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(-1, 100, (257, 3)).astype(np.int32)
    valid = rng.random(257) > 0.5
    want = ref_bindings.compact(ref_bindings.BindingTable(
        jnp.asarray(rows), jnp.asarray(valid), jnp.asarray(True)))
    got = bindings.compact(bindings.BindingTable(
        _t(rows), _t(valid), torch.tensor(True)))
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert bool(got.overflow) and got.rows.dtype == torch.int32


def test_unit_table_and_set_column_match_reference():
    want = ref_bindings.unit_table(8, 3)
    got = bindings.unit_table(8, 3, device="cpu")
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert not bool(got.overflow) and got.overflow.shape == ()
    assert got.cap == 8 and got.n_vars == 3 and int(got.count()) == 1
    vals = np.arange(8, dtype=np.int64) * 7
    out = bindings.set_column(got.rows, 1, _t(vals))
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(ref_bindings.set_column(want.rows, 1,
                                                        jnp.asarray(vals))))
    assert int(got.rows[0, 1]) == -1  # out of place: the input is unchanged


def test_eqrange_basic():
    keys = _t(np.array([1, 3, 3, 3, 7, 9], np.int64))
    q = _t(np.array([0, 1, 3, 5, 9, 10], np.int64))
    lo, hi = ops.eqrange(keys, q)
    np.testing.assert_array_equal(lo.numpy(), [0, 0, 1, 4, 5, 6])
    np.testing.assert_array_equal(hi.numpy(), [0, 1, 4, 4, 6, 6])


def test_run_contains_basic():
    vals = _t(np.array([1, 2, 4, 4, 6, 9, 0, 5], np.int32))
    lo = _t(np.array([0, 0, 2, 5, 6, 3], np.int32))
    hi = _t(np.array([6, 6, 5, 5, 8, 3], np.int32))
    t = _t(np.array([4, 3, 6, 9, 5, 1], np.int32))
    np.testing.assert_array_equal(ops.run_contains(vals, lo, hi, t).numpy(),
                                  [True, False, True, False, True, False])


def test_searchsorted_in_runs_basic():
    vals = np.array([1, 2, 4, 4, 6, 9], np.int32)
    lo = np.array([0, 2, 0, 4], np.int32)
    hi = np.array([6, 5, 0, 6], np.int32)
    t = np.array([4, 5, 3, 10], np.int32)
    got = ops.searchsorted_in_runs(_t(vals), _t(lo), _t(hi), _t(t)).numpy()
    want = [a + np.searchsorted(vals[a:b], v, "left")
            for a, b, v in zip(lo, hi, t)]
    np.testing.assert_array_equal(got, want)
