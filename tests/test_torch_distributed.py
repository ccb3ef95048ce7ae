"""The port's sharded engine against the JAX package's, exactly:
``DistributedEngine.run_batch`` (whole ``rows`` and ``valid`` and all six
``DistStats`` fields per lane) at 1–4 shards, owner masking on and off,
on the four interfaces, on a mixed batch and in an overflowing case; the
k-way merge against the reference's lexsort; and ``run_batch`` against
the port's own serial engine over the five loads.

The reference lowers ``run_batch`` onto a ``data x model`` device mesh,
which needs several JAX devices while the rest of the suite sees one, so
it runs in subprocesses with 8 forced host devices (as
``tests/test_distributed.py`` does), each writing its lanes to an npz
file that a module-scoped fixture reads.  The port evaluates the shards
in a loop on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from _torch import bgp_tuples, port_bgp, port_store, torch

from repro.core import stepper as ref_stepper
from repro.rdf import generate_query_load
from repro.rdf.queries import QueryLoadConfig
from repro_torch.core import EngineConfig, QueryEngine, results_as_numpy
from repro_torch.core import stepper
from repro_torch.core.distributed import (DistConfig, DistributedEngine,
                                          DistStats)
from repro_torch.kernels import ops

LOADS = ("1-star", "2-stars", "3-stars", "paths", "union")
INTERFACES = ("tpf", "brtpf", "spf", "endpoint")
ROOT = Path(__file__).resolve().parents[1]

# (name, interface, n_shards, owner_masking, cap, shard_cap, queries as
# (load, index)).  The reference compiles one step per engine and plan
# signature, a few seconds each, growing with the number of units: the
# per-triple-pattern interfaces take their few-unit queries.
CASES = [
    ("spf-1-owner-mixed", "spf", 1, True, 2048, 1024,
     [("1-star", 0), ("paths", 1), ("1-star", 1), ("union", 0)]),
    ("spf-2", "spf", 2, False, 2048, 1024, [("2-stars", 0)]),
    ("spf-2-owner", "spf", 2, True, 2048, 1024, [("2-stars", 1)]),
    ("spf-3-owner", "spf", 3, True, 2048, 1024, [("3-stars", 0)]),
    ("spf-4-owner", "spf", 4, True, 2048, 1024, [("paths", 0)]),
    ("spf-4", "spf", 4, False, 2048, 1024, [("1-star", 0), ("1-star", 1)]),
    ("brtpf-4-owner", "brtpf", 4, True, 2048, 1024,
     [("1-star", 0), ("1-star", 1)]),
    ("brtpf-2", "brtpf", 2, False, 2048, 1024, [("paths", 1)]),
    ("endpoint-3", "endpoint", 3, False, 2048, 1024, [("2-stars", 1)]),
    ("endpoint-2-owner", "endpoint", 2, True, 2048, 1024, [("union", 1)]),
    ("tpf-3-owner", "tpf", 3, True, 2048, 1024, [("union", 0)]),
    ("tpf-1", "tpf", 1, False, 2048, 1024, [("1-star", 1)]),
    ("spf-3-owner-overflow", "spf", 3, True, 16, 8, [("paths", 1)]),
]

_REF_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.rdf import TripleStore, WatDivConfig, generate_watdiv, generate_query_load
from repro.rdf.queries import QueryLoadConfig
from repro.core import EngineConfig
from repro.core.distributed import DistributedEngine, DistConfig

cases, out_path = json.loads(sys.argv[1]), sys.argv[2]
g = generate_watdiv(WatDivConfig(scale=10))
store = TripleStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                          n_predicates=g.n_predicates)
loads = {l: generate_query_load(g, store, l, QueryLoadConfig(n_queries=2))
         for l in set(l for c in cases for l, _ in c[6])}
out = {}
for name, iface, n, owner, cap, shard_cap, sel in cases:
    # Auto axes: a mixed batch indexes the step's lane-sharded outputs,
    # which explicit-sharding axes refuse to gather without out_sharding
    mesh = jax.make_mesh((n, 1), ("data", "model"), devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    eng = DistributedEngine(store, mesh, EngineConfig(interface=iface),
                            DistConfig(cap=cap, shard_cap=shard_cap,
                                       owner_masking=owner))
    qs = [loads[l][j] for l, j in sel]
    rows, valid, stats = eng.run_batch(qs)
    stacked = not isinstance(rows, list)
    out[f"{name}/stacked"] = np.asarray(stacked)
    for lane, q in enumerate(qs):
        out[f"{name}/{lane}/rows"] = np.asarray(rows[lane])
        out[f"{name}/{lane}/valid"] = np.asarray(valid[lane])
        st = [np.asarray(f)[lane] if stacked else np.asarray(f)
              for f in (stats if stacked else stats[lane])]
        out[f"{name}/{lane}/stats"] = np.array([int(x) for x in st], np.int64)
        out[f"{name}/{lane}/bgp"] = np.array(json.dumps(
            [[[t.is_var, t.id] for t in (tp.s, tp.p, tp.o)]
             for tp in q.patterns]))
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's runs here are thousands of small eager ops: with
    torch's intra-op threads they spin against the other test workers
    for the cores (tens of times slower on a loaded machine), with one
    thread they do not."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(watdiv_small):
    g, ref_store = watdiv_small
    loads = {load: generate_query_load(g, ref_store, load,
                                       QueryLoadConfig(n_queries=2))
             for load in LOADS}
    return ref_store, port_store(ref_store), loads


@pytest.fixture(scope="module")
def ref_lanes(tmp_path_factory):
    """Every case's reference lanes, from three subprocesses at once."""
    tmp = tmp_path_factory.mktemp("ref_dist")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    procs = []
    for k in range(3):
        out = tmp / f"part{k}.npz"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", _REF_SCRIPT, json.dumps(CASES[k::3]),
             str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    lanes = {}
    for out, proc in procs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-3000:]
        with np.load(out) as z:
            lanes.update({k: z[k] for k in z.files})
    return lanes


def _stats_ints(stats) -> list[int]:
    return [int(x) for x in stats]


def _lanes(rows, valid, stats, n):
    """A ``run_batch`` result as per-lane ``(rows, valid, stats)`` numpy
    triples, whether it came stacked or as lists."""
    if isinstance(rows, list):
        return [(rows[i].numpy(), valid[i].numpy(), _stats_ints(stats[i]))
                for i in range(n)]
    return [(rows[i].numpy(), valid[i].numpy(),
             _stats_ints(DistStats(*(f[i] for f in stats))))
            for i in range(n)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_run_batch_matches_reference(world, ref_lanes, case):
    name, iface, n, owner, cap, shard_cap, sel = case
    _, store, loads = world
    qs = [loads[load][j] for load, j in sel]
    eng = DistributedEngine(store, EngineConfig(interface=iface),
                            DistConfig(cap=cap, shard_cap=shard_cap,
                                       owner_masking=owner),
                            n_shards=n, device="cpu")
    before = dict(ops.LAUNCHES)
    rows, valid, stats = eng.run_batch([port_bgp(q) for q in qs])
    assert ops.LAUNCHES == before  # the CPU runs the plain versions
    assert isinstance(rows, list) == (not bool(ref_lanes[f"{name}/stacked"]))
    for lane, (r, v, s) in enumerate(_lanes(rows, valid, stats, len(qs))):
        key = f"{name}/{lane}"
        pats, _ = bgp_tuples(qs[lane])
        assert json.loads(str(ref_lanes[f"{key}/bgp"])) == \
            [[list(t) for t in p] for p in pats]
        want_r, want_v = ref_lanes[f"{key}/rows"], ref_lanes[f"{key}/valid"]
        assert r.dtype == want_r.dtype and r.shape == want_r.shape, key
        np.testing.assert_array_equal(r, want_r, err_msg=key)
        np.testing.assert_array_equal(v, want_v, err_msg=key)
        assert s == ref_lanes[f"{key}/stats"].tolist(), key
    if name.endswith("overflow"):
        assert all(bool(ref_lanes[f"{name}/{i}/stats"][5])
                   for i in range(len(qs)))


@pytest.mark.parametrize("interface", INTERFACES)
def test_run_batch_matches_serial_engine(world, interface):
    """Every lane's valid rows equal the port's serial ``QueryEngine.run``
    byte for byte over the five loads at 1–4 shards, with nothing
    overflowing; ``n_results`` is the serial count."""
    _, store, loads = world
    serial = QueryEngine(store, EngineConfig(interface=interface),
                         device="cpu")
    want = {}
    for load, qs in loads.items():
        for j, q in enumerate(qs):
            tbl, st = serial.run(port_bgp(q))
            want[load, j] = (results_as_numpy(tbl), int(st.n_results))
    for n in (1, 2, 3, 4):
        eng = DistributedEngine(store, EngineConfig(interface=interface),
                                DistConfig(cap=4096, shard_cap=4096,
                                           owner_masking=n % 2 == 0),
                                n_shards=n, device="cpu")
        for load, qs in loads.items():
            got = _lanes(*eng.run_batch([port_bgp(q) for q in qs]), len(qs))
            for j, (r, v, s) in enumerate(got):
                rows, count = want[load, j]
                assert r[v].tobytes() == rows.tobytes(), (n, load, j)
                assert s[4] == count and s[5] == 0, (n, load, j)


def test_traffic_ordering(world):
    """The paper's ordering, as ``tests/test_distributed.py`` asserts it:
    star granularity exchanges in fewer rounds and bytes than per-triple
    brTPF, and the endpoint in no more rounds than SPF."""
    _, store, loads = world
    out = {}
    for iface in ("spf", "brtpf", "endpoint"):
        eng = DistributedEngine(store, EngineConfig(interface=iface),
                                DistConfig(), n_shards=4, device="cpu")
        out[iface] = [_lanes(*eng.run_batch([port_bgp(q)]), 1)[0][2]
                      for q in loads["2-stars"]]
    for spf, brtpf, endpoint in zip(out["spf"], out["brtpf"],
                                    out["endpoint"]):
        assert spf[0] <= brtpf[0] and spf[2] <= brtpf[2]
        assert endpoint[0] <= spf[0]


@pytest.mark.parametrize("interface", INTERFACES)
def test_planning_matches_reference(world, interface):
    """``plan_batch`` and ``group_by_signature`` plan on the whole store
    as the reference's engine does (no mesh needed to plan)."""
    from repro.core.distributed import DistributedEngine as RefEngine
    from repro.core import EngineConfig as RefConfig

    ref_store, store, loads = world
    ref = RefEngine.__new__(RefEngine)  # planning reads store and cfg only
    ref.store, ref.cfg = ref_store, RefConfig(interface=interface)
    eng = DistributedEngine(store, EngineConfig(interface=interface),
                            n_shards=3, device="cpu")
    qs = [q for load in LOADS for q in loads[load]]
    want = ref.group_by_signature(qs)
    got = eng.group_by_signature([port_bgp(q) for q in qs])
    assert list(got) == list(want)
    for sig, group in want.items():
        assert [bgp_tuples(q) for q in got[sig]] == \
            [bgp_tuples(q) for q in group]
        w_plan, w_consts = ref.plan_batch(group)
        plan, consts = eng.plan_batch([port_bgp(q) for q in group])
        assert plan.signature == w_plan.signature and plan.n_vars == \
            w_plan.n_vars
        np.testing.assert_array_equal(consts, w_consts)
    if len(want) > 1:
        with pytest.raises(ValueError, match="plan-homogeneous"):
            eng.plan_batch([port_bgp(q) for q in qs])


def test_run_load_waits_for_the_scheduler_slice(world):
    _, store, loads = world
    eng = DistributedEngine(store, EngineConfig(), n_shards=2, device="cpu")
    with pytest.raises(NotImplementedError, match="5b"):
        eng.run_load(loads["1-star"])


def test_engine_defaults_to_card(world, monkeypatch):
    _, store, _ = world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DistributedEngine(store, EngineConfig(), n_shards=2)
    with pytest.raises(ValueError, match="n_shards"):
        DistributedEngine(store, EngineConfig(), n_shards=0, device="cpu")


# ------------------------------------------------------------------ merge

def _blocks(rng, n_blocks, cap=64):
    """Pre-sorted blocks with unique (c0, c1) keys and -1 invalid tails."""
    blocks, base = [], 0
    for _ in range(n_blocks):
        n_valid = int(rng.integers(0, cap + 1))
        rows = np.full((cap, 3), -1, np.int32)
        rows[:n_valid, 0] = np.sort(rng.integers(0, 40, n_valid))
        rows[:n_valid, 1] = base + np.arange(n_valid)
        rows[:n_valid, 2] = rng.integers(0, 1000, n_valid)
        base += n_valid
        blocks.append((rows, np.arange(cap) < n_valid))
    return blocks


def _ref_lexsort(blocks, trim, sort_cols):
    trimmed = [ref_stepper._trim_block(jnp.asarray(r), jnp.asarray(v), trim)
               for r, v in blocks]
    rows = np.concatenate([np.asarray(r) for r, _, _ in trimmed])
    valid = np.concatenate([np.asarray(v) for _, v, _ in trimmed])
    want_r, want_v = ref_stepper.lexsort_rows(jnp.asarray(rows),
                                              jnp.asarray(valid), sort_cols)
    return (np.asarray(want_r), np.asarray(want_v),
            any(bool(l) for _, _, l in trimmed))


def test_shard_merge_blocks_kway_matches_lexsort():
    """Twin of ``tests/test_scheduler.py``'s: pairwise rank-based merges
    of pre-sorted blocks — trim-truncated ones with blanked invalid tails
    included — reproduce the reference's full lexsort byte for byte,
    invalid regions included."""
    rng = np.random.default_rng(7)
    sort_cols = (0, 1)
    for n_blocks, trim_frac in [(2, 1.0), (4, 1.0), (8, 1.0), (4, 0.5)]:
        blocks = _blocks(rng, n_blocks)
        trim = int(64 * trim_frac)
        trimmed = [stepper._trim_block(torch.from_numpy(r),
                                       torch.from_numpy(v), trim)
                   for r, v in blocks]
        want_r, want_v, lost = _ref_lexsort(blocks, trim, sort_cols)
        assert any(bool(l) for _, _, l in trimmed) == lost
        acc_r, acc_v, _ = trimmed[0]
        for r, v, _ in trimmed[1:]:
            acc_r, acc_v = stepper.merge_sorted_blocks(acc_r, acc_v, r, v,
                                                       sort_cols)
        np.testing.assert_array_equal(acc_r.numpy(), want_r)
        np.testing.assert_array_equal(acc_v.numpy(), want_v)


@pytest.mark.parametrize("n_blocks", [2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("trim", [64, 24])
@pytest.mark.parametrize("out_cap", [64, 128, 1024])
def test_gather_merge_kway_matches_lexsort(n_blocks, trim, out_cap):
    """The k-way merge's whole output (the -1 invalid tail included, cut
    or padded to ``out_cap``) against the reference's lexsort of the
    trimmed blocks, as its ``gather_merge`` pads it, and ``lost``."""
    rng = np.random.default_rng(100 * n_blocks + trim)
    sort_cols = (1, 0)
    blocks = _blocks(rng, n_blocks)
    got_r, got_v, lost = stepper.gather_merge_kway(
        [(torch.from_numpy(r), torch.from_numpy(v)) for r, v in blocks],
        sort_cols, out_cap, trim)
    want_r, want_v, want_lost = _ref_lexsort(blocks, trim, sort_cols)
    want_r, want_v, _ = ref_stepper._pad_to_cap(
        jnp.asarray(want_r), jnp.asarray(want_v), out_cap, None)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert bool(lost) == want_lost


@pytest.mark.parametrize("cap,n_shards", [(16, 1), (2048, 2), (2048, 3),
                                          (1 << 16, 4), (1 << 20, 7)])
def test_shard_trim_matches_reference(cap, n_shards):
    assert stepper.shard_trim(cap, n_shards) == \
        ref_stepper.shard_trim(cap, n_shards)
