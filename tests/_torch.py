"""Shared helpers of the PyTorch port's tests (``tests/test_torch_*.py``).

Importing this module skips the importing test module where torch is not
installed.  The ``cuda_device`` fixture decides inside the test whether
there is a card (never at import or collection time, so every worker
collects the same tests) and skips with a reason where there is none;
tests that use it carry the ``cuda`` marker.

The converters carry the JAX reference's store (index and delta overlay)
and queries into the port as plain numpy arrays, triple sets and
``(is_var, id)`` tuples — the same store and the same BGPs in both
packages.
"""

import pytest

torch = pytest.importorskip("torch")

HOST_FIELDS = ("h_key_ps", "h_s_pso", "h_o_pso", "h_key_po", "h_s_pos",
               "h_o_pos", "h_pred_offsets")
DELTA_FIELDS = ("h_ins_key_ps", "h_ins_s_pso", "h_ins_o_pso",
                "h_ins_key_po", "h_ins_s_pos", "h_ins_o_pos",
                "h_tomb_pos_ps", "h_tomb_adj_ps", "h_tomb_pos_po",
                "h_tomb_adj_po")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda")


def port_store(ref_store):
    """The port's store over the reference store's numpy index and delta
    overlay (its delta columns, canonical sets and epoch counters)."""
    from repro_torch.rdf.store import TripleStore

    return TripleStore.from_host_arrays(
        {f: getattr(ref_store, f) for f in HOST_FIELDS + DELTA_FIELDS},
        ref_store.n_terms, ref_store.n_predicates,
        inserts=ref_store._ins_set, tombstones=ref_store._tomb_set,
        epoch=ref_store.epoch, base_epoch=ref_store.base_epoch)


def bgp_tuples(bgp):
    """Any BGP (either package's) as plain ``(patterns, n_vars)`` data."""
    pats = [tuple((t.is_var, t.id) for t in (tp.s, tp.p, tp.o))
            for tp in bgp.patterns]
    return pats, bgp.n_vars


def port_bgp(ref_bgp):
    """A reference BGP as the port's BGP."""
    from repro_torch.core.patterns import bgp_from_tuples

    return bgp_from_tuples(*bgp_tuples(ref_bgp))
