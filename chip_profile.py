"""Where the port's warm query time goes on one NVIDIA GPU.

    python3 chip_profile.py        # from the repository root; needs one card
    python3 chip_profile.py --lm   # the LM passes alone
    python3 chip_profile.py --single-p   # attention with P as one bf16

Builds what ``chip_smoke.py`` runs — the paper's 10M-triple WatDiv store
and 3 queries of each of the five loads — and profiles three stores in
turn: the static store; the live store after ``chip_smoke.py``'s three
1% write windows (the same seeded ``WriteFeed``); and a store rebuilt
from the live store's merged triples, which answers the same.  For each
it runs every query under the four interfaces on the card (planner on)
once, to fill the planner's high-water marks, times one warm pass over
all of them untraced (host wall clock, synchronised), and traces a
second warm pass with ``torch.profiler``.  On the static store it also
profiles ``chip_smoke.py``'s serving stream (240 requests from 16
clients) through the scheduler: a cold drain, a warm drain, and the
stream with the cache and collapsing off; and ``chip_smoke.py``'s phase
7b run of ``DistributedEngine.run_batch`` (SPF, 4 shards, each load's
queries one batch at the load's cap) with owner masking on and off,
each followed by a traced replay of that pass's k-way merges alone,
whose device busy time over the pass's is the merges' share.  Last, it
profiles the LM path of ``chip_smoke.py``'s phase 8: qwen2-7b at its published width
and depth, one B = 1, S = 4096 prefill and 8 greedy decode steps at
B = 8 against a 32768-position cache.  It prints, per pass:

- the untraced and traced pass walls, the device's busy time in the
  traced pass (the sum of every kernel, copy and fill CUPTI recorded; one
  stream, so they do not overlap) and hence the device's idle share;
- device work items (kernels, copies, fills) per query (per prefill, per
  decoded token), and each kernel's launches and share of the device
  time;
- the device work items and the host-side operations that took the most
  time.

The tracer's own cost inflates the traced wall; the untraced wall is the
one to quote.  ``--single-p`` instead times the wgmma attention kernel
against a variant of its source that feeds P to the P V product as one
bf16 value (the ``lo`` product removed), built into ``build/single_p/``,
and holds both to ``chip_smoke.py``'s elementwise bf16 bound.  Exits
non-zero where there is no card or the trace holds no device time.
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
    cuda = torch.device("cuda", 0)

    def trace(label, what, run_all, n_q, unit="query") -> float:
        """Run ``run_all`` once (warm-up), once timed, once traced, and
        print where the traced pass's time went; ``n_q`` of ``unit``
        (queries, prefills, tokens) each.  Returns the traced pass's
        device busy time in us (0 where the trace holds none)."""
        run_all()
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
            return 0.0
        items = sum(e.count for e in device)
        print(f"== {label}: {what}")
        print(f"wall untraced {untraced * 1e3:.3f} ms "
              f"({untraced * 1e3 / n_q:.3f} ms/{unit}), traced "
              f"{traced * 1e3:.3f} ms; device busy {busy_us / 1e3:.3f} ms "
              f"= {busy_us / 1e6 / untraced:.1%} of the untraced wall, "
              f"{busy_us / 1e6 / traced:.1%} of the traced wall "
              f"(idle share {1 - busy_us / 1e6 / traced:.1%} traced)")
        print(f"device work items: {items} ({items / n_q:.1f} per {unit})")
        for name in _build.KERNELS:
            mine = [e for e in device if f"{name}_kernel" in e.key]
            t = sum(_us(e, "device") for e in mine)
            n = sum(e.count for e in mine)
            print(f"{name}: {n} launches ({n / n_q:.1f} per {unit}), "
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
        return busy_us

    def profile_pass(label, store) -> float:
        engines = [core.QueryEngine(store, core.EngineConfig(interface=i),
                                    device=cuda) for i in core.INTERFACES]
        work = [(eng, q) for eng in engines for qs in loads.values()
                for q in qs]

        def run_all():
            for eng, q in work:
                eng.run(q)
            torch.cuda.synchronize()

        run_all()  # cold: fills the planners' high-water marks
        return trace(
            f"{label} store", f"{store.n_triples} triples, delta "
            f"{store.delta_size}; warm pass over {len(work)} queries "
            f"({len(engines)} interfaces x "
            f"{sum(map(len, loads.values()))} queries, planner on)",
            run_all, len(work))

    def serving_passes(store) -> float:
        """chip_smoke's serving stream (16 clients, SPF, lanes 8) through
        the scheduler: a cold drain (a fresh scheduler each time), a warm
        drain (one scheduler, drained twice before), and the stream with
        the cache and collapsing off (a fresh scheduler each time)."""
        queries = [q for qs in loads.values() for q in qs]
        stream = core.interleave_clients(queries, smoke.CLIENTS)
        cfg = core.EngineConfig()

        def drain(scfg, sched=None):
            def run_all():
                s = sched or core.QueryScheduler(store, cfg, scfg,
                                                 device=cuda)
                s.serve(stream)
                torch.cuda.synchronize()
            return run_all

        lanes = core.SchedulerConfig(lanes=smoke.LANES)
        warm = core.QueryScheduler(store, cfg, lanes, device=cuda)
        warm.serve(stream)
        what = f"{len(stream)} requests, {len(queries)} distinct queries"
        return (trace("serving cold", what + ", a fresh scheduler",
                      drain(lanes), len(stream))
                and trace("serving warm", what + ", one warm scheduler",
                          drain(lanes, warm), len(stream))
                and trace("serving, cache and collapsing off", what,
                          drain(core.SchedulerConfig(
                              lanes=smoke.LANES, use_cache=False,
                              collapse_duplicates=False)), len(stream)))

    def sharded_passes(store) -> bool:
        """The 4-shard SPF ``run_batch`` of ``chip_smoke.py``'s phase 7b,
        owner masking on and off, then its k-way merges replayed alone
        (the pass's ``gather_merge_kway`` calls, captured untraced)."""
        from repro_torch.core import stepper
        from repro_torch.core.distributed import (DistConfig,
                                                  DistributedEngine)

        plan = smoke.sharded_plan(torch, core, store, loads, ["spf"], cuda)
        n_q = sum(len(p[0]) for p in plan.values())
        merge = stepper.gather_merge_kway
        for owner in (True, False):
            batches = [
                (DistributedEngine(store, core.EngineConfig(), DistConfig(
                    cap=cap, shard_cap=cap, owner_masking=owner),
                    n_shards=4, device=cuda), [loads[load][i] for i in keep])
                for (_, load), (keep, cap, *_) in plan.items()]

            def run_all():
                for eng, qs in batches:
                    eng.run_batch(qs)
                torch.cuda.synchronize()

            label = f"sharded, owner masking {'on' if owner else 'off'}"
            busy = trace(label, f"SPF run_batch at 4 shards over {n_q} "
                         f"queries, each load one batch at its cap "
                         f"{[p[1] for p in plan.values()]}", run_all, n_q)
            calls = []
            stepper.gather_merge_kway = \
                lambda *a: calls.append(a) or merge(*a)
            try:
                run_all()
            finally:
                stepper.gather_merge_kway = merge

            def merges():
                for a in calls:
                    merge(*a)
                torch.cuda.synchronize()

            busy_m = trace(f"{label}: its k-way merges alone",
                           f"{len(calls)} gather_merge_kway calls", merges,
                           n_q)
            del calls
            if not busy or not busy_m:
                return False
            print(f"{label}: the k-way merges take {busy_m / busy:.1%} of "
                  f"the pass's device busy time")
        return True

    if "--lm" in sys.argv[1:]:
        return 0 if lm_passes(torch, cuda, trace) else 1
    if "--single-p" in sys.argv[1:]:
        return 0 if single_p(torch, cuda) else 1
    g, store = smoke.watdiv_store(smoke.SCALE)
    loads = smoke.query_loads(g, store)
    if not profile_pass("static", store) or not serving_passes(store) \
            or not sharded_passes(store):
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
    del g, store, rebuilt, loads, feed
    torch.cuda.empty_cache()
    return 0 if lm_passes(torch, cuda, trace) else 1


def lm_passes(torch, cuda, trace) -> float:
    """qwen2-7b as ``chip_smoke.py``'s phase 8 serves it: a traced warm
    prefill, then traced passes of 8 greedy decode steps."""
    import chip_smoke as smoke
    from repro_torch.configs.steps import build_cell
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.serving import make_decode_step

    cell = build_cell(smoke.LM_ARCH, "prefill_32k")
    cfg = cell.model_cfg
    gen = torch.Generator(cuda).manual_seed(smoke.SEED)
    with torch.inference_mode():
        model = Transformer(cfg, device=cuda, generator=gen)
        tokens = torch.randint(0, cfg.vocab, (smoke.PREFILL_BATCH,
                                              smoke.PREFILL_SEQ),
                               generator=gen, device=cuda, dtype=torch.int32)

        def prefill():
            cell.fn(model, {"tokens": tokens})
            torch.cuda.synchronize()

        cache = smoke.random_cache(torch, model, smoke.DECODE_BATCH,
                                   smoke.DECODE_CACHE, gen)
        token = torch.randint(0, cfg.vocab, (smoke.DECODE_BATCH,),
                              generator=gen, device=cuda, dtype=torch.int32)
        step = make_decode_step(cell.family, cfg)

        def decode():
            greedy_decode(model, step, token, cache, smoke.DECODE_CACHE // 2,
                          smoke.DECODE_TOKENS)

        return (trace("LM prefill", f"{smoke.LM_ARCH} full width, "
                      f"B={smoke.PREFILL_BATCH} S={smoke.PREFILL_SEQ}",
                      prefill, 1, unit="prefill")
                and trace("LM decode", f"{smoke.LM_ARCH} full width, "
                          f"{smoke.DECODE_TOKENS} greedy steps at "
                          f"B={smoke.DECODE_BATCH} against a "
                          f"{smoke.DECODE_CACHE}-position cache", decode,
                          smoke.DECODE_TOKENS, unit="token"))


def single_p(torch, cuda) -> bool:
    """The wgmma attention kernel (P fed to P V as a hi + lo pair of bf16
    fragments) against the same source with the ``lo`` product removed,
    at the qwen2-7b and a D = 256 prefill shape: CUDA-event means in
    turns (split, single, single, split), and each one's worst elementwise
    ratio to ``chip_smoke.py``'s bf16 bound and the elements over it."""
    import ctypes
    import subprocess

    import chip_smoke as smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    src = (_build.CSRC / "flash_attention_wgmma.cu").read_text()
    lo = "            wgmma_rs(acc[c], p_lo[kk], dv);\n"
    if src.count(lo) != 1:
        print("chip_profile: the lo product is not in the wgmma source",
              file=sys.stderr)
        return False
    out = ROOT / "build" / "single_p"
    out.mkdir(parents=True, exist_ok=True)
    (out / "single_p.cu").write_text(src.replace(lo, ""))
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                    str(out / "single_p.so"), str(out / "single_p.cu")],
                   check=True)
    launch = ctypes.CDLL(str(out / "single_p.so")) \
        .flash_attention_wgmma_launch
    ptr, ll = ctypes.c_void_p, ctypes.c_longlong
    launch.argtypes = [ptr] * 4 + [ll] * 6 + [ptr, ctypes.c_float,
                                              ctypes.c_int, ptr]
    launch.restype = ctypes.c_int

    def single(q, k, v):
        b, hq, sq, d = q.shape
        o = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
        st = (ll * 12)(*q.stride(), *k.stride(), *v.stride())
        code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      b, hq, k.shape[1], sq, k.shape[2], d,
                      ctypes.cast(st, ptr), 1.0 / d ** 0.5, 1,
                      torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"single-P variant launch failed: {code}")
        return o

    cfg = smoke.lm_config()
    gen = torch.Generator(cuda).manual_seed(smoke.SEED + 3)
    for shape in ((smoke.PREFILL_BATCH, cfg.n_heads, cfg.n_kv,
                   smoke.PREFILL_SEQ, smoke.PREFILL_SEQ, cfg.head_dim),
                  (1, 16, 16, smoke.PREFILL_SEQ, smoke.PREFILL_SEQ, 256)):
        q, k, v = smoke.attention_operands(torch, gen, shape, torch.bfloat16)
        want = fa.flash_attention_plain(q, k, v).float()
        step = smoke.ATTN_BF16_STEPS * want.abs() + smoke.ATTN_BF16_ABS
        fns = {"split": lambda: fa.flash_attention_wgmma_cuda(q, k, v),
               "single": lambda: single(q, k, v)}
        times = {name: [] for name in fns}
        for name in [*fns, *reversed(fns)]:
            times[name].append(smoke.cuda_ms(torch, fns[name]))
        print(f"== P fed to P V at {shape}, bf16, causal "
              f"(card: {smoke.card_line()})")
        for name, fn in fns.items():
            diff = (fn().float() - want).abs()
            turns = ", ".join(f"{t:.4f}" for t in times[name])
            print(f"{name}: {sum(times[name]) / 2:.4f} ms ({turns}); worst "
                  f"{float((diff / step).max()):.4g} of the bf16 bound, "
                  f"{int((diff > step).sum())} elements over it")
        del q, k, v, want
    return True


if __name__ == "__main__":
    sys.exit(main())
