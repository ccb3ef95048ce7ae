"""Where the port's warm query time goes on one NVIDIA GPU.

    python3 chip_profile.py        # from the repository root; needs one card

Builds what ``chip_smoke.py`` runs — the paper's 10M-triple WatDiv store
and 3 queries of each of the five loads — and profiles three stores in
turn: the static store; the live store after ``chip_smoke.py``'s three
1% write windows (the same seeded ``WriteFeed``); and a store rebuilt
from the live store's merged triples, which answers the same.  For each
it runs every query under the four interfaces on the card (planner on)
once, to fill the planner's high-water marks, times one warm pass over
all of them untraced (host wall clock, synchronised), and traces a
second warm pass with ``torch.profiler``.  It prints, per store:

- the untraced and traced pass walls, the device's busy time in the
  traced pass (the sum of every kernel, copy and fill CUPTI recorded; one
  stream, so they do not overlap) and hence the device's idle share;
- device work items (kernels, copies, fills) per query, and each probe
  kernel's launches and share of the device time;
- the device work items and the host-side operations that took the most
  time.

The tracer's own cost inflates the traced wall; the untraced wall is the
one to quote.  Exits non-zero where there is no card or the trace holds
no device time.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def _us(evt, kind: str) -> float:
    """An event's self time on ``kind`` ("device" or "cpu"), in us."""
    if kind == "cpu":
        return evt.self_cpu_time_total
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as smoke
    from repro_torch import core
    from repro_torch.kernels import _build
    from repro_torch.rdf import TripleStore
    from repro_torch.rdf.writes import WriteFeed

    print(f"card: {smoke.card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    _build.build()
    g, store = smoke.watdiv_store(smoke.SCALE)
    loads = smoke.query_loads(g, store)
    cuda = torch.device("cuda", 0)

    def profile_pass(label, store) -> bool:
        engines = [core.QueryEngine(store, core.EngineConfig(interface=i),
                                    device=cuda) for i in core.INTERFACES]
        work = [(eng, q) for eng in engines for qs in loads.values()
                for q in qs]

        def run_all():
            for eng, q in work:
                eng.run(q)
            torch.cuda.synchronize()

        run_all()  # cold: fills the planners' high-water marks
        t0 = time.perf_counter()
        run_all()
        untraced = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_all()
            traced = time.perf_counter() - t0

        events = prof.key_averages()
        device = [e for e in events if e.device_type == DeviceType.CUDA]
        busy_us = sum(_us(e, "device") for e in device)
        if busy_us <= 0:
            print(f"chip_profile: the {label} trace holds no device time",
                  file=sys.stderr)
            return False
        n_q = len(work)
        items = sum(e.count for e in device)
        print(f"== {label} store: {store.n_triples} triples, delta "
              f"{store.delta_size}; warm pass over {n_q} queries "
              f"({len(engines)} interfaces x "
              f"{sum(map(len, loads.values()))} queries, planner on)")
        print(f"wall untraced {untraced * 1e3:.3f} ms "
              f"({untraced * 1e3 / n_q:.3f} ms/query), traced "
              f"{traced * 1e3:.3f} ms; device busy {busy_us / 1e3:.3f} ms "
              f"= {busy_us / 1e6 / untraced:.1%} of the untraced wall, "
              f"{busy_us / 1e6 / traced:.1%} of the traced wall "
              f"(idle share {1 - busy_us / 1e6 / traced:.1%} traced)")
        print(f"device work items: {items} ({items / n_q:.1f} per query)")
        for name in _build.KERNELS:
            mine = [e for e in device if f"{name}_kernel" in e.key]
            t = sum(_us(e, "device") for e in mine)
            n = sum(e.count for e in mine)
            print(f"{name}: {n} launches ({n / n_q:.1f} per query), "
                  f"{t / 1e3:.3f} ms = {t / busy_us:.1%} of device busy "
                  f"time")
        print("top device work by self time:")
        for e in sorted(device, key=lambda e: -_us(e, "device"))[:12]:
            print(f"  {_us(e, 'device') / 1e3:9.3f} ms  {e.count:6d} x  "
                  f"{e.key[:90]}")
        host = [e for e in events if e.device_type == DeviceType.CPU]
        print("top host operations by self CPU time:")
        for e in sorted(host, key=lambda e: -_us(e, "cpu"))[:12]:
            print(f"  {_us(e, 'cpu') / 1e3:9.3f} ms  {e.count:6d} x  "
                  f"{e.key[:90]}")
        return True

    if not profile_pass("static", store):
        return 1
    read_preds = {t.p.id for qs in loads.values() for q in qs
                  for t in q.patterns if not t.p.is_var}
    feed = WriteFeed(store, read_preds, rate=0.01, seed=smoke.SEED)
    for _ in range(3):
        store.apply_delta(**feed.next_window())
    rebuilt = TripleStore.build(*store.merged_triples(),
                                n_terms=store.n_terms,
                                n_predicates=store.n_predicates)
    if not profile_pass("live", store) or \
            not profile_pass("rebuilt", rebuilt):
        return 1
    return 0

if __name__ == "__main__":
    sys.exit(main())
