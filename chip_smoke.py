"""Run the PyTorch port's SPF engine on one NVIDIA GPU and check it: over
a static store, then over the live store under writes.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure exits non-zero; there is no CPU fallback):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions.
2. Build the three CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together).
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
6. The live store: three write windows on the same 10M-triple store, each
   1% of it (half deletes, half inserts; half on the loads' predicates,
   half on the two most populated others; from the second window on 5%
   re-inserting the last window's deletes and 5% deleting its inserts —
   ``repro_torch.rdf.writes``).  After each window the five loads x four
   interfaces run on the card against the live store, with the launch
   counts set to 0 just before and read just after, and every query's
   rows and overflow flag must equal those of the same query on the card
   against a ``TripleStore.build`` of the merged triple set; at least one
   answer per window must differ from the static store's; the base
   tensors must stay where they were.  After the third window one query
   per load and interface must also equal the port's CPU run (rows and
   six stats), the delta probe and the int32 sorted probe are held
   against their plain versions at the live shapes, and then
   ``compact()`` must give a base bit-equal to the rebuilt store's and
   the same answers.

The line before the last is the kernel report as JSON; the last line is
``{"ok": true, "device": {...}}``.  Times are CUDA-event means over
repeated launches (kernels) or host wall clock around a synchronised
query, write or upload (engine, store).
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


def delta_kernel_phase(torch, np, store, dev):
    """The delta probe and the int32 sorted probe against their plain
    versions on the card, at the live path's shapes (the delta as it
    stands, 2^20 probe keys); returns the delta probe's report entry."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.delta_probe import (delta_probe_cuda,
                                                 delta_probe_plain)
    from repro_torch.kernels.sorted_probe import (sorted_probe_cuda,
                                                  sorted_probe_plain)

    rng = np.random.default_rng(SEED + 1)
    cuda = dev.key_ps_pso.device
    q = PROBE_QUERIES
    n_base = store.n_base
    ins, tomb = dev.ins_key_ps, dev.tomb_pos_ps
    m, t = ins.shape[0], tomb.shape[0]
    check(m > 0 and t > 0, "the live store has inserts and tombstones")
    # probe keys: PSO hits, misses and extremes, a quarter insert-key hits
    k_np = probe_queries(np, store, rng, q)
    k_np[rng.integers(0, q, q // 4)] = store.h_ins_key_ps[
        rng.integers(0, m, q // 4)]
    k_np[:2] = [np.iinfo(np.int64).max, np.iinfo(np.int64).min]
    keys = torch.from_numpy(k_np).to(cuda)
    lo, hi = ops.eqrange(dev.key_ps_pso, keys)  # the base runs
    lo[2:6] = torch.tensor([0, n_base, 7, n_base], dtype=torch.int32)
    hi[2:6] = torch.tensor([0, n_base, 7, n_base], dtype=torch.int32)
    args = (ins, tomb, keys, lo, hi)
    got = delta_probe_cuda(*args)
    want = delta_probe_plain(*args)
    torch.cuda.synchronize()
    err = max_abs_err(torch, got, want)
    check(err == 0, "delta_probe kernel == plain at the live shapes")
    hi_cnt = got[1] - got[0]
    ins_hits = int((hi_cnt > 0).sum())
    check(ins_hits > 0 and int((got[3] > got[2]).sum()) > 0,
          "the delta probe's inputs hit inserts and tombstones")
    dp_ms = cuda_ms(torch, lambda: delta_probe_cuda(*args))
    dp_plain = cuda_ms(torch, lambda: delta_probe_plain(*args))
    dp_lib = cuda_ms(torch, lambda: (
        torch.searchsorted(ins, keys, side="left", out_int32=True),
        torch.searchsorted(ins, keys, side="right", out_int32=True),
        torch.searchsorted(tomb, lo, side="left", out_int32=True),
        torch.searchsorted(tomb, hi, side="left", out_int32=True)))
    steps = 2 * math.ceil(math.log2(m + 1)) + 2 * math.ceil(math.log2(t + 1))
    dp_bound, dp_by = bound(m * 8 + t * 4 + q * (8 + 4 + 4) + q * 4 * 4,
                            q * steps)
    print(f"delta_probe: m={m} inserts, t={t} tombstones, q={q} keys, "
          f"{ins_hits} insert runs hit; kernel {dp_ms:.4f} ms, plain "
          f"{dp_plain:.4f} ms, torch.searchsorted x4 {dp_lib:.4f} ms, bound "
          f"{dp_bound:.4f} ms ({dp_by}: both delta columns, every key, run "
          f"bound and output once; {steps} compares per key)")

    # the int32 x int32 instantiation on the tombstone column
    p_np = rng.integers(0, n_base + 1, q).astype(np.int32)
    p_np[rng.integers(0, q, q // 4)] = store.h_tomb_pos_ps[
        rng.integers(0, t, q // 4)]
    p_np[:4] = [0, n_base, np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    pos = torch.from_numpy(p_np).to(cuda)
    got = sorted_probe_cuda(tomb, pos)
    want = sorted_probe_plain(tomb, pos)
    torch.cuda.synchronize()
    err32 = max_abs_err(torch, got, want)
    check(err32 == 0, "int32 sorted_probe kernel == plain on the "
          "tombstone column")
    s_ms = cuda_ms(torch, lambda: sorted_probe_cuda(tomb, pos))
    s_plain = cuda_ms(torch, lambda: sorted_probe_plain(tomb, pos))
    s_lib = cuda_ms(torch, lambda: (
        torch.searchsorted(tomb, pos, side="left", out_int32=True),
        torch.searchsorted(tomb, pos, side="right", out_int32=True)))
    s_bound, s_by = bound(t * 4 + q * 4 + q * (4 + 4 + 1),
                          2 * q * math.ceil(math.log2(t + 1)))
    print(f"sorted_probe int32: t={t} tombstones, q={q} positions, "
          f"{int(got[2].sum())} hits, max_abs_err {err32}; kernel "
          f"{s_ms:.4f} ms, plain {s_plain:.4f} ms, torch.searchsorted x2 "
          f"{s_lib:.4f} ms, bound {s_bound:.4f} ms ({s_by})")
    return {"name": "delta_probe", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/delta_probe.cu",
            "replaces": "src/repro/kernels/delta_probe.py:110",
            "launches": 0, "max_abs_err": err, "ms": dp_ms,
            "plain_ms": dp_plain, "bound_ms": dp_bound, "bound_by": dp_by,
            "library_ms": dp_lib}


def rows_and_overflow(result) -> tuple:
    """A query outcome's valid rows and overflow flag."""
    (rows, shape, stats), _ = result
    return rows, shape, stats[5]


def live_phase(torch, np, core, store, loads, static, cuda):
    """Three write windows, the live path on the card after each, the
    checks of module docstring phase 6, and compaction.  ``static`` is
    the main path's card run on the static store.  Returns the delta
    probe's report entry, the live path's launch counts and the live
    and rebuilt warm walls."""
    from repro_torch.kernels import ops
    from repro_torch.rdf import TripleStore
    from repro_torch.rdf.writes import WriteFeed

    base_ptrs = [t.data_ptr() for t in store.device_arrays(cuda)[:6]]
    read_preds = {t.p.id for qs in loads.values() for q in qs
                  for t in q.patterns if not t.p.is_var}
    feed = WriteFeed(store, read_preds, rate=0.01,
                     seed=SEED)
    print(f"live: read predicates {sorted(read_preds)}, feed predicates "
          f"{feed.feed_preds.tolist()}")
    launches = {name: 0 for name in ops.LAUNCHES}
    walls = {load: ([], []) for load in loads}
    for w in (1, 2, 3):
        t0 = time.perf_counter()
        window = feed.next_window()
        t_gen = time.perf_counter() - t0
        t0 = time.perf_counter()
        store.apply_delta(**window)
        t_apply = time.perf_counter() - t0
        t0 = time.perf_counter()
        dev = store.device_arrays(cuda)
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        delta_bytes = sum(x.numel() * x.element_size() for x in dev[6:])
        check([x.data_ptr() for x in dev[:6]] == base_ptrs,
              f"window {w}: the base stays resident on the card")
        print(f"window {w}: {window['insert'][0].shape[0]} inserts + "
              f"{window['delete'][0].shape[0]} deletes -> epoch "
              f"{store.epoch}, {store.n_triples} live triples, delta "
              f"m={dev.ins_key_ps.shape[0]} t={dev.tomb_pos_ps.shape[0]}; "
              f"generated in {t_gen:.3f} s, apply_delta {t_apply:.3f} s, "
              f"delta upload {t_upload:.4f} s ({delta_bytes / 1e6:.2f} MB)")
        t0 = time.perf_counter()
        rebuilt = TripleStore.build(*store.merged_triples(),
                                    n_terms=store.n_terms,
                                    n_predicates=store.n_predicates)
        print(f"window {w}: rebuilt store built in "
              f"{time.perf_counter() - t0:.1f} s")

        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        live = main_path(torch, core, store, loads, cuda, planner_off=False)
        t_live = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        for name, c in counts.items():
            launches[name] += c
        check(counts["delta_probe"] > 0,
              f"window {w}: the delta probe ran on the live path")
        t0 = time.perf_counter()
        want = main_path(torch, core, rebuilt, loads, cuda,
                         planner_off=False)
        t_rebuilt = time.perf_counter() - t0
        changed = 0
        for key, got in live.items():
            check(rows_and_overflow(got) == rows_and_overflow(want[key]),
                  f"window {w}: live == rebuilt for {key}")
            changed += got[0][0] != static[key][0][0]
            walls[key[0]][0].append(got[1])
            walls[key[0]][1].append(want[key][1])
        check(changed > 0, f"window {w}: some answer changed")
        print(f"window {w}: {len(live)} queries on the card equal the "
              f"rebuilt store's in rows and overflow, {changed} answer "
              f"differently from the static store; live path {t_live:.1f} s "
              f"(cold + warm), rebuilt {t_rebuilt:.1f} s, launches {counts}")

    # ---- the CPU subset on the last window
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    n_cpu = 0
    for load, qs in loads.items():
        for iface in core.INTERFACES:
            eng = core.QueryEngine(store, core.EngineConfig(interface=iface),
                                   device="cpu")
            got = outcome(core, *eng.run(qs[0]))
            check(got == live[(load, iface, True, 0)][0],
                  f"card == CPU on the live store for {load} {iface}")
            n_cpu += 1
    check(all(v == 0 for v in ops.LAUNCHES.values()),
          "no kernel launched on the CPU path")
    print(f"window 3: {n_cpu} queries equal on card and CPU (rows and six "
          f"stats) in {time.perf_counter() - t0:.1f} s on the CPU")

    # ---- the delta-side kernels at the live shapes
    entry = delta_kernel_phase(torch, np, store, dev)

    # ---- compaction
    t0 = time.perf_counter()
    store.compact()
    t_compact = time.perf_counter() - t0
    check(store.delta_size == 0, "compaction empties the delta")
    for f in ("h_key_ps", "h_s_pso", "h_o_pso", "h_key_po", "h_s_pos",
              "h_o_pos", "h_pred_offsets"):
        check(np.array_equal(getattr(store, f), getattr(rebuilt, f)),
              f"compacted {f} == rebuilt")
    after = main_path(torch, core, store, loads, cuda, planner_off=False)
    for key, got in after.items():
        check(got[0] == want[key][0], f"after compaction: {key}")
    print(f"compaction: {t_compact:.2f} s; base bit-equal to the rebuilt "
          f"store, {len(after)} queries equal its answers")
    return entry, launches, walls


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


def main_path(torch, core, store, loads, device, planner_off=True):
    """Every query through ``QueryEngine.run`` on ``device``: the planner
    on for all loads and interfaces (a cold run, then a warm timed one),
    plus the first load with the planner off.  Returns
    ``{(load, interface, planner, i): (outcome, warm seconds)}``."""
    out = {}
    runs = [(load, iface, True) for load in loads for iface in core.INTERFACES]
    if planner_off:
        runs += [(next(iter(loads)), iface, False)
                 for iface in core.INTERFACES]
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

    t_start = time.perf_counter()
    phases = {}
    # ---- 1. the card
    smi = card_line()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    cuda = torch.device("cuda", 0)

    # ---- 2. build the kernels
    t_phase = time.perf_counter()
    print(f"build: {_build.build():.2f} s for {', '.join(_build.KERNELS)} "
          f"(0 = already built)")
    phases["2 build"] = time.perf_counter() - t_phase

    # ---- 3. the 10M-triple store on the card
    t_phase = t0 = time.perf_counter()
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
    phases["3 store"] = time.perf_counter() - t_phase

    # ---- 4. kernels against their plain versions
    t_phase = time.perf_counter()
    report = kernel_phase(torch, np, store, dev)
    phases["4 kernels"] = time.perf_counter() - t_phase

    # ---- 5. the main path on the card, then the same queries on the CPU
    t_phase = t0 = time.perf_counter()
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
    phases["5 main path"] = time.perf_counter() - t_phase

    # ---- 6. the live store: writes, the merged path, compaction
    t_phase = time.perf_counter()
    entry, live_launches, walls = live_phase(torch, np, core, store, loads,
                                             on_card, cuda)
    entry["launches"] = live_launches["delta_probe"]
    report.append(entry)
    print(f"live path: kernel launches over the three windows "
          f"{live_launches}")
    for load, (live, rebuilt) in walls.items():
        print(f"live {load:8s}: warm query wall {np.mean(live) * 1e3:8.3f} "
              f"ms on the live store, {np.mean(rebuilt) * 1e3:8.3f} ms on "
              f"the rebuilt store (mean of {len(live)})")
    phases["6 live store"] = time.perf_counter() - t_phase
    print("phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phases.items())
        + f"; total {time.perf_counter() - t_start:.1f}")

    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
