"""The port's serial engine against the JAX package's, exactly: plans,
``eval_unit`` per unit, and ``QueryEngine.run`` (valid-row bytes and the
six gross ``QueryStats`` fields) for the four interfaces and the five
WatDiv loads, with the capacity planner on and off, under forced
overflow, resume at unit k and the ``max_cap`` latch — on the same index
and the same queries in both packages."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from _torch import port_bgp, port_store, torch

import repro.core as rc
from repro.core import bindings as ref_bindings
from repro.core import server as ref_server
from repro.rdf import generate_query_load
from repro.rdf.queries import QueryLoadConfig
from repro_torch import obs
from repro_torch.core import bindings, engine, oracle, server
from repro_torch.core import EngineConfig, QueryEngine, results_as_numpy

LOADS = ("1-star", "2-stars", "3-stars", "paths", "union")
INTERFACES = ("tpf", "brtpf", "spf", "endpoint")


@pytest.fixture(scope="module")
def world(watdiv_small):
    g, ref_store = watdiv_small
    loads = {load: generate_query_load(g, ref_store, load,
                                       QueryLoadConfig(n_queries=2))
             for load in LOADS}
    return g, ref_store, port_store(ref_store), loads


def _outcome(tbl, stats, as_numpy):
    rows = as_numpy(tbl)
    return (rows.dtype, rows.shape, rows.tobytes(),
            tuple(int(x) for x in stats)[:6], bool(tbl.overflow))


# Reference runs by (config, queries).  Compiling the reference's jitted
# steps dominates this file's time, so each reference configuration runs
# once and every port run that shares it is held against the same
# outcomes.
_REF_RUNS: dict = {}


def _ref_outcomes(ref_store, qs, **cfg):
    key = (tuple(sorted(cfg.items())), tuple(map(id, qs)))
    if key not in _REF_RUNS:
        eng = rc.QueryEngine(ref_store, rc.EngineConfig(**cfg))
        _REF_RUNS[key] = (eng, [_outcome(*eng.run(q), rc.results_as_numpy)
                                for q in qs])
    return _REF_RUNS[key]


def _assert_port_matches(world, qs, **cfg):
    """Run ``qs`` through the port on the CPU and the reference under the
    same config; returns both engines."""
    _, ref_store, store, _ = world
    ref_eng, want = _ref_outcomes(ref_store, qs, **cfg)
    eng = QueryEngine(store, EngineConfig(**cfg), device="cpu")
    for i, (q, w) in enumerate(zip(qs, want)):
        assert _outcome(*eng.run(port_bgp(q)), results_as_numpy) == w, \
            (cfg, i)
    return ref_eng, eng


@pytest.mark.parametrize("interface", INTERFACES)
def test_plans_identical(world, interface):
    _, ref_store, store, loads = world
    for load, qs in loads.items():
        for q in qs:
            want = rc.engine.plan_query(ref_store, q,
                                        rc.EngineConfig(interface=interface))
            got = engine.plan_query(store, port_bgp(q),
                                    EngineConfig(interface=interface))
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            assert got.signature == want.signature


@pytest.mark.parametrize("load", LOADS)
def test_eval_unit_matches_reference(world, load):
    """Every unit of every plan (star units under SPF, triple-pattern
    units under TPF), seeded with the same table, gives the same rows,
    valid mask, overflow flag, ops and peak.  A capacity of 64 makes some
    units overflow."""
    _, ref_store, store, loads = world
    ref_dev, dev = ref_store.device, store.device_arrays("cpu")
    logn = server.log_factor(store.n_triples)
    for interface in ("spf", "tpf"):
        for q in loads[load]:
            plan = engine.plan_query(store, port_bgp(q),
                                     EngineConfig(interface=interface))
            r_plan = rc.engine.plan_query(ref_store, q,
                                          rc.EngineConfig(interface=interface))
            n_vars = max(plan.n_vars, 1)
            r_consts = jnp.asarray(np.asarray(plan.consts, np.int64))
            consts = torch.tensor(plan.consts, dtype=torch.int64)
            r_tbl = ref_bindings.unit_table(64, n_vars)
            for k, (up, r_up) in enumerate(zip(plan.units, r_plan.units)):
                want = ref_server.eval_unit(ref_dev, ref_store.radix, r_up,
                                            r_consts, r_tbl, logn=logn)
                seed = bindings.BindingTable(
                    torch.from_numpy(np.array(r_tbl.rows)),
                    torch.from_numpy(np.array(r_tbl.valid)),
                    torch.tensor(bool(r_tbl.overflow)))
                got = server.eval_unit(dev, store.radix, up, consts, seed,
                                       logn=logn)
                ctx = (load, interface, k)
                w_tbl, w_ops, w_peak = want
                g_tbl, g_ops, g_peak = got
                assert g_tbl.rows.dtype == torch.int32
                np.testing.assert_array_equal(g_tbl.rows.numpy(),
                                              np.asarray(w_tbl.rows), str(ctx))
                np.testing.assert_array_equal(g_tbl.valid.numpy(),
                                              np.asarray(w_tbl.valid))
                assert bool(g_tbl.overflow) == bool(w_tbl.overflow), ctx
                assert g_ops.dtype == torch.int64
                assert int(g_ops) == int(w_ops), ctx
                assert int(g_peak) == int(w_peak), ctx
                r_tbl = w_tbl


@pytest.mark.parametrize("interface", INTERFACES)
@pytest.mark.parametrize("planner", [True, False])
def test_run_matches_reference(world, interface, planner):
    """One query of each load; results also agree with the brute-force
    oracle."""
    g, _, _, loads = world
    qs = [loads[load][0] for load in LOADS]
    ref_eng, eng = _assert_port_matches(world, qs, interface=interface,
                                        cap=2048, capacity_planner=planner)
    for q in qs:
        pq = port_bgp(q)
        truth = oracle.eval_bgp_bruteforce(g.s, g.p, g.o, pq)
        assert truth and oracle.table_to_solution_set(
            results_as_numpy(eng.run(pq)[0])) == truth
    if planner:  # the two planners saw the same capacities
        assert dict(eng.planner._hwm) == dict(ref_eng.planner._hwm)


@pytest.mark.parametrize("interface", INTERFACES)
@pytest.mark.parametrize("planner", [True, False])
def test_forced_overflow_matches_reference(world, interface, planner):
    """A tiny starting capacity: the blind ladder climbs 4x rungs, the
    planner starts at oracle capacities.  Both port paths are held
    against the reference's planned run, which its own suite pins
    byte-identical to its blind one (``tests/test_capacity.py``)."""
    _, ref_store, store, loads = world
    qs = loads["2-stars"]
    _, want = _ref_outcomes(ref_store, qs, interface=interface, cap=4)
    eng = QueryEngine(store, EngineConfig(interface=interface, cap=4,
                                          capacity_planner=planner),
                      device="cpu")
    for i, q in enumerate(qs):
        assert _outcome(*eng.run(port_bgp(q)), results_as_numpy) == want[i]


@pytest.mark.parametrize("planner", [True, False])
def test_max_cap_latch_matches_reference(world, planner):
    """Even ``max_cap`` overflows: both packages latch the flag and return
    the identical truncated evaluation."""
    _, ref_store, store, loads = world
    qs = loads["2-stars"] + loads["3-stars"]
    _, want = _ref_outcomes(ref_store, qs, interface="spf", cap=4,
                            max_cap=16)
    assert any(w[4] for w in want)  # the latch case actually happened
    eng = QueryEngine(store, EngineConfig(interface="spf", cap=4, max_cap=16,
                                          capacity_planner=planner),
                      device="cpu")
    for i, q in enumerate(qs):
        assert _outcome(*eng.run(port_bgp(q)), results_as_numpy) == want[i]


def test_resume_at_unit_k_matches_reference(world):
    """A deliberately small high-water mark forces resume at the
    overflowed unit; the result still equals the reference's."""
    _, ref_store, store, loads = world
    qs = loads["2-stars"]
    _, want = _ref_outcomes(ref_store, qs, interface="spf", cap=4)
    eng = QueryEngine(store, EngineConfig(interface="spf", cap=4),
                      device="cpu")
    for i, q in enumerate(qs):
        pq = port_bgp(q)
        plan = eng.plan(pq)
        for k in range(len(plan.units)):
            eng.planner.observe_unit(plan, k, 4)
        assert _outcome(*eng.run(pq), results_as_numpy) == want[i]


def test_engine_defaults_to_card(world, monkeypatch):
    _, _, store, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(store, EngineConfig())
    with pytest.raises(ValueError, match="unknown interface"):
        QueryEngine(store, EngineConfig(interface="sparql"), device="cpu")


def test_obs_hook_records_latency_only_when_enabled(world, monkeypatch):
    _, _, store, loads = world
    eng = QueryEngine(store, EngineConfig(), device="cpu")
    q = port_bgp(loads["1-star"][0])
    before = obs.snapshot()
    eng.run(q)
    assert obs.snapshot() == before  # disabled: no mutation
    monkeypatch.setattr(obs, "enabled", True)
    monkeypatch.setattr(obs, "registry", obs.MetricsRegistry())
    eng.run(q)
    assert obs.snapshot()["engine.query_latency_s"]["count"] == 1
