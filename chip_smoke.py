"""Run the PyTorch port's serial SPF engine on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure exits non-zero; there is no CPU fallback):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions.
2. Build both CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together).
3. Build the paper's 10M-triple WatDiv store (``scale=20_500``) and put
   its index on the card.
4. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, bit-equal, with the kernel's, the plain
   version's and (for the sorted probe) ``torch.searchsorted``'s times,
   and the least time the card could take.
5. The main path: five WatDiv loads x four interfaces, a few queries
   each, through ``QueryEngine.run`` on the card (planner on; one load
   also with the planner off), with the kernels' launch counts set to 0
   just before and read just after.  Every query's valid rows and first
   six ``QueryStats`` fields must equal the port's own CPU run of it, and
   no kernel may launch during the CPU runs.  A small store is also
   checked against the brute-force oracle.

The line before the last is the kernel report as JSON; the last line is
``{"ok": true, "device": {...}}``.  Times are CUDA-event means over
repeated launches (kernels) or host wall clock around a synchronised
query (engine).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCALE = 20_500  # WatDiv scale of the paper's 10M-triple store
QUERIES_PER_LOAD = 3
PROBE_QUERIES = 1 << 20  # the largest table a query reaches (max_cap)
SEED = 0
# H100 SXM published peaks (NVIDIA data sheet, at the 700 W limit): HBM
# bytes/s, and the 32-bit non-tensor-core rate taken for the integer
# compares of a bisection (the data sheet gives no int64 rate).
HBM_BYTES_S = 3.35e12
SCALAR_OPS_S = 67e12
SECTOR_BYTES = 32


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(torch, got, want) -> int:
    err = 0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape, "output types")
        d = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = ops / SCALAR_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_queries(np, store, rng, q: int):
    """``q`` int64 probe keys for the PSO key column: hits, misses,
    below-min, above-max, the int64 extremes and the negative keys of
    UNBOUND rows (``p*R - 1``)."""
    keys = store.h_key_ps
    n = keys.shape[0]
    parts = [
        keys[rng.integers(0, n, q // 2)],                      # hits
        rng.integers(int(keys[0]), int(keys[-1]), q // 4),     # mostly misses
        int(keys[0]) - rng.integers(1, 1 << 20, q // 16),      # below min
        int(keys[-1]) + rng.integers(1, 1 << 20, q // 16),     # above max
        np.arange(store.n_predicates, dtype=np.int64) * store.radix - 1,
        np.array([np.iinfo(np.int64).max, np.iinfo(np.int64).min, -1, 0]),
    ]
    out = np.concatenate([np.asarray(p, np.int64) for p in parts])
    out = np.concatenate([out, keys[rng.integers(0, n, q - out.shape[0])]])
    return out[rng.permutation(q)]


def kernel_phase(torch, np, store, dev):
    """Each kernel against its plain version on the card; returns the
    report entries (launch counts filled in later)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.run_probe import run_probe_cuda, run_probe_plain
    from repro_torch.kernels.sorted_probe import (sorted_probe_cuda,
                                                  sorted_probe_plain)

    rng = np.random.default_rng(SEED)
    cuda = dev.key_ps_pso.device
    keys = dev.key_ps_pso
    n = keys.shape[0]
    q_np = probe_queries(np, store, rng, PROBE_QUERIES)
    queries = torch.from_numpy(q_np).to(cuda)

    # ---- sorted probe: main-path shape, the 2-query bound, an empty column
    got = sorted_probe_cuda(keys, queries)
    want = sorted_probe_plain(keys, queries)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    check(err == 0, "sorted_probe kernel == plain at 2^20 queries")
    p = int(store.h_key_ps[n // 2] // store.radix)
    two = torch.tensor([p * store.radix, (p + 1) * store.radix],
                       dtype=torch.int64, device=cuda)
    check(max_abs_err(torch, sorted_probe_cuda(keys, two),
                      sorted_probe_plain(keys, two)) == 0,
          "sorted_probe kernel == plain at 2 queries")
    empty = torch.zeros(0, dtype=torch.int64, device=cuda)
    check(max_abs_err(torch, sorted_probe_cuda(empty, queries[:1024]),
                      sorted_probe_plain(empty, queries[:1024])) == 0,
          "sorted_probe kernel == plain on an empty column")
    hits = int(got[2].sum())
    sp_ms = cuda_ms(torch, lambda: sorted_probe_cuda(keys, queries))
    sp_plain = cuda_ms(torch, lambda: sorted_probe_plain(keys, queries))
    sp_lib = cuda_ms(torch, lambda: (
        torch.searchsorted(keys, queries, side="left", out_int32=True),
        torch.searchsorted(keys, queries, side="right", out_int32=True)))
    q = PROBE_QUERIES
    logn = math.ceil(math.log2(n))
    sp_bound, sp_by = bound(n * 8 + q * 8 + q * (4 + 4 + 1), 2 * q * logn)
    sp_bisect = q * logn * SECTOR_BYTES / HBM_BYTES_S * 1e3
    print(f"sorted_probe: n={n} q={q} hits={hits} kernel {sp_ms:.4f} ms, "
          f"plain {sp_plain:.4f} ms, torch.searchsorted x2 {sp_lib:.4f} ms, "
          f"bound {sp_bound:.4f} ms ({sp_by}: every key, query and output "
          f"once), bisection bound {sp_bisect:.4f} ms ({logn} dependent "
          f"{SECTOR_BYTES}-byte sectors per query from HBM)")

    # ---- run probe: o_pso runs of the probed (p, s) keys, int64 targets
    lo, hi = ops.eqrange(keys, queries)
    lo_np, hi_np = lo.cpu().numpy(), hi.cpu().numpy()
    o_np = store.h_o_pso
    nonempty = hi_np > lo_np
    pick = np.where(nonempty, lo_np + (rng.random(q) * np.maximum(
        hi_np - lo_np, 1)).astype(np.int64), 0)
    t_np = np.where(rng.random(q) < 0.5, o_np[pick].astype(np.int64),
                    rng.integers(0, store.n_terms, q))
    t_np[:2] = [np.iinfo(np.int64).max, -1]
    targets = torch.from_numpy(t_np).to(cuda)
    values = dev.o_pso
    got = run_probe_cuda(values, lo, hi, targets)
    want = run_probe_plain(values, lo, hi, targets)
    torch.cuda.synchronize()
    err_rp = max_abs_err(torch, got, want)
    check(err_rp == 0, "run_probe kernel == plain at 2^20 rows")
    rp_ms = cuda_ms(torch, lambda: run_probe_cuda(values, lo, hi, targets))
    rp_plain = cuda_ms(torch, lambda: run_probe_plain(values, lo, hi,
                                                      targets))
    # the values this run's rows can touch: the union of their runs
    cover = np.zeros(n + 1, np.int64)
    np.add.at(cover, lo_np[nonempty], 1)
    np.add.at(cover, hi_np[nonempty], -1)
    touched = int((np.cumsum(cover)[:n] > 0).sum())
    run_len = (hi_np - lo_np)[nonempty]
    steps = float(np.ceil(np.log2(run_len + 1)).sum())
    rp_bound, rp_by = bound(touched * 4 + q * (4 + 4 + 8) + q * (4 + 1),
                            steps)
    rp_bisect = steps * SECTOR_BYTES / HBM_BYTES_S * 1e3
    print(f"run_probe: n={n} rows={q} non-empty runs={int(nonempty.sum())} "
          f"hits={int(got[1].sum())} kernel {rp_ms:.4f} ms, plain "
          f"{rp_plain:.4f} ms, bound {rp_bound:.4f} ms ({rp_by}: the "
          f"{touched} values inside the runs, every row and output once), "
          f"bisection bound {rp_bisect:.4f} ms ({int(steps)} dependent "
          f"sectors in all)")
    return [
        {"name": "sorted_probe", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sorted_probe.cu",
         "replaces": "src/repro/kernels/sorted_probe.py:107",
         "launches": 0, "max_abs_err": err, "ms": sp_ms,
         "plain_ms": sp_plain, "bound_ms": sp_bound, "bound_by": sp_by,
         "library_ms": sp_lib},
        {"name": "run_probe", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/run_probe.cu",
         "replaces": "src/repro/kernels/run_probe.py:243",
         "launches": 0, "max_abs_err": err_rp, "ms": rp_ms,
         "plain_ms": rp_plain, "bound_ms": rp_bound, "bound_by": rp_by,
         "library_ms": None},
    ]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def watdiv_store(scale: int):
    """The WatDiv graph at ``scale`` and its store (host index)."""
    from repro_torch.rdf import TripleStore, WatDivConfig, generate_watdiv

    g = generate_watdiv(WatDivConfig(scale=scale))
    return g, TripleStore.build(g.s, g.p, g.o, n_terms=g.n_terms,
                                n_predicates=g.n_predicates)


def query_loads(g, store) -> dict:
    """``QUERIES_PER_LOAD`` queries of each of the paper's five loads."""
    from repro_torch.rdf import QueryLoadConfig, generate_query_load
    from repro_torch.rdf.queries import QUERY_LOADS

    return {load: generate_query_load(g, store, load, QueryLoadConfig(
        n_queries=QUERIES_PER_LOAD)) for load in QUERY_LOADS}


def outcome(core, tbl, stats):
    rows = core.results_as_numpy(tbl)
    return rows.tobytes(), rows.shape, tuple(int(x) for x in stats)[:6]


def main_path(torch, core, store, loads, device):
    """Every query through ``QueryEngine.run`` on ``device``: the planner
    on for all loads and interfaces (a cold run, then a warm timed one),
    plus the first load with the planner off.  Returns
    ``{(load, interface, planner, i): (outcome, warm seconds)}``."""
    out = {}
    runs = [(load, iface, True) for load in loads for iface in core.INTERFACES]
    runs += [(next(iter(loads)), iface, False) for iface in core.INTERFACES]
    for load, iface, planner in runs:
        eng = core.QueryEngine(store, core.EngineConfig(
            interface=iface, capacity_planner=planner), device=device)
        for i, q in enumerate(loads[load]):
            eng.run(q)  # cold: the planner records high-water marks
            t0 = time.perf_counter()
            tbl, stats = eng.run(q)
            if device.type == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out[(load, iface, planner, i)] = (outcome(core, tbl, stats), wall)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch import core
    from repro_torch.core import oracle
    from repro_torch.kernels import _build, ops

    # ---- 1. the card
    smi = card_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    cuda = torch.device("cuda", 0)

    # ---- 2. build the kernels
    print(f"build: {_build.build():.2f} s for {', '.join(_build.KERNELS)} "
          f"(0 = already built)")

    # ---- 3. the 10M-triple store on the card
    t0 = time.perf_counter()
    g, store = watdiv_store(SCALE)
    t_build = time.perf_counter() - t0
    dev = store.device_arrays(cuda)
    torch.cuda.synchronize()
    index_bytes = sum(t.numel() * t.element_size() for t in dev)
    print(f"store: scale={SCALE} triples={store.n_triples} "
          f"predicates={store.n_predicates} terms={store.n_terms}, "
          f"generated and built in {t_build:.1f} s, "
          f"{index_bytes / 1e6:.1f} MB on the card")
    check(store.n_triples > 9_000_000, "a 10M-triple store")

    # ---- 4. kernels against their plain versions
    report = kernel_phase(torch, np, store, dev)

    # ---- 5. the main path on the card, then the same queries on the CPU
    t0 = time.perf_counter()
    loads = query_loads(g, store)
    print(f"queries: {QUERIES_PER_LOAD} per load generated in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    on_card = main_path(torch, core, store, loads, cuda)
    t_card = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    print(f"main path on the card: {len(on_card)} queries (cold + warm) in "
          f"{t_card:.1f} s, kernel launches {launches}")
    for entry in report:
        entry["launches"] = launches[entry["name"]]
        check(entry["launches"] > 0, f"{entry['name']} ran on the main path")

    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    on_cpu = main_path(torch, core, store, loads, torch.device("cpu"))
    print(f"same queries on the CPU in {time.perf_counter() - t0:.1f} s")
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          "no kernel launched on the CPU path")
    overflowed = 0
    for key, (got, wall) in on_card.items():
        want, wall_cpu = on_cpu[key]
        load, iface, planner, i = key
        check(got == want, f"card == CPU for {key}")
        overflowed += int(got[2][5])
        print(f"query {load:8s} {iface:8s} planner={int(planner)} #{i}: "
              f"{got[1][0]:7d} rows, stats {got[2][:5]}, warm "
              f"{wall * 1e3:9.3f} ms on the card, {wall_cpu * 1e3:9.1f} ms "
              f"on the CPU")
    print(f"main path: {len(on_card)} queries equal on card and CPU "
          f"({overflowed} latched at max_cap)")

    # ---- the answers against brute force, on a small store
    gs, small = watdiv_store(10)
    n_checked = 0
    for load, qs in query_loads(gs, small).items():
        for q in qs:
            truth = oracle.eval_bgp_bruteforce(gs.s, gs.p, gs.o, q)
            for iface in core.INTERFACES:
                eng = core.QueryEngine(small, core.EngineConfig(
                    interface=iface, cap=256))
                tbl, _ = eng.run(q)
                check(oracle.table_to_solution_set(
                    core.results_as_numpy(tbl)) == truth,
                    f"oracle agreement {load} {iface}")
                n_checked += 1
    print(f"oracle: {n_checked} card runs on a scale-10 store agree with "
          f"brute force")

    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
