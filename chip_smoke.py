"""Run the PyTorch port on one NVIDIA GPU and check it: the SPF engine
over a static store, over the live store under writes, serving a
16-client stream through the scheduler, the batched engine over the
subject-hash-sharded store, then the LM stack serving qwen2-7b at its
published width and depth.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure exits non-zero; there is no CPU fallback):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions.
2. Build the eight CUDA kernels from ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` per source, started together).
3. Build the paper's 10M-triple WatDiv store (``scale=20_500``) and put
   its index on the card.
4. Each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, bit-equal, with the kernel's, the plain
   version's and (for the sorted probe) ``torch.searchsorted``'s times,
   and the least time the card could take.  The wave fingerprint and the
   cache-hit replay run at the serving path's largest shapes (8 lanes of
   2^20 rows), and are also held against their host twins
   (``ref.fingerprint_prefix_np``, ``fragcache.replay``).
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
7. Serving, on the compacted store: the five loads' 15 queries
   interleaved over 16 clients (240 requests, SPF, planner on, waves of
   8 lanes) through one ``QueryScheduler`` on the card, drained three
   times (cold, warm, warm again), with the launch counts set to 0 just
   before the first drain and read after the second.  Every response's
   rows, overflow and six stats must equal the serial
   ``QueryEngine.run`` on the card; the second drain must replay units
   (the replay kernel) and no all-hit wave may pull a table to the host
   beyond an overflow retire.  Then the same stream with collapsing off
   and the cache on, drained twice (240 jobs in waves of 8 lanes that
   share keys; the fingerprint on such waves in both drains, the replay
   in the second), and with the cache and collapsing off through
   ``QueryEngine.run_load``, TPF / brTPF /
   endpoint with 4 clients, and a 1% write window submitted while the
   stream is pending: every response equals the serial engine on the
   post-write store (twice), cache entries and planner marks over
   untouched predicates carry over, and no answer holds a tombstoned
   triple.
7b. The sharded store, on the store as phase 7 leaves it (its write
   window a delta over the compacted base): the store sharded by subject
   hash at 4 and at 2 shards (each partition and upload timed; every
   shard must hold inserts and tombstones), then (a) the owner-masked
   probe against its plain version, bit-equal, at 2^20 bound-subject
   rows drawn from the store against shard 0's PSO key column at 4
   shards for every ``my_shard`` (each owning about a quarter), and at
   the edges (int64-extreme queries and subjects, one shard, 4097 and
   10007 shards, an empty column and batch, 1001 rows), timed beside
   its plain version, two ``torch.searchsorted`` calls and its bound;
   (b) ``DistributedEngine.run_batch`` on the card: SPF, brTPF, endpoint
   and TPF at 4 shards with owner masking, SPF at 4 shards without it
   and SPF at 2 shards with it, each load's queries one batch at the
   load's cap (the smallest power of two holding every unit's peak in
   the load's serial runs; queries whose serial peak exceeds 2^25 rows
   are left out), with the launch counts set to 0 just before each
   configuration and read just after: every lane's valid rows equal the
   serial ``QueryEngine.run`` on the card byte for byte, ``n_results``
   equals its count, nothing overflows, and the owner-masked probe
   launches exactly when owner masking is on; one query per load (SPF,
   4 shards, owner masking) and a deliberately overflowing cap of 1024
   give rows, valid and all six ``DistStats`` fields equal to the
   port's CPU run, which launches no kernel.  Then phase 7's write is
   undone (no delta left; the shards' base tensors stay where they
   were) and the SPF configurations run again against the serial
   engine.  The store's tensors, shards included, are freed before
   phase 8.
8. LM serving, after the store's tensors are freed: (a) both
   flash-attention kernels against their plain version on the card,
   through the dispatcher, over the reference's sweep in float32 and
   bfloat16, the qwen2-7b prefill shape and a D = 256 case (the bf16
   cases at D 64 / 128 / 256 go to the wgmma kernel, the rest to the
   simple one, and each launch is checked to go where the rule sends
   it), then at the qwen2-7b shape in bf16 the simple kernel called
   directly, and the wgmma kernel's, the simple kernel's,
   ``scaled_dot_product_attention``'s and the plain version's times, in
   turns; (b) qwen2-7b at its published width and depth (random weights
   from a seeded generator): a B = 1, S = 4096 prefill through the
   ``prefill_32k`` cell, which must launch the wgmma kernel exactly once
   per layer and nothing else and give finite logits, then 8 greedy
   decode steps (twice) at B = 8 against a 32768-position cache filled
   on the card, which launch no kernel; (c) the same model at 2 layers
   in float32 on the CPU (plain attention) and on the card (the simple
   kernel, once per layer): logits within 1e-3 and the same argmax at
   every position.

The line before the last is the kernel report as JSON; the last line is
``{"ok": true, "device": {...}}``.  Times are CUDA-event means over
repeated launches (kernels) or host wall clock around a synchronised
query, write or upload (engine, store).
"""

from __future__ import annotations

import gc
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
CLIENTS = 16  # the serving phase's simulated clients
LANES = 8  # the serving phase's wave width
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet, 700 W): the
# least time of attention's products, whatever units a kernel uses
BF16_TENSOR_FLOPS_S = 989e12
LM_ARCH = "qwen2-7b"  # phase 8: served at its published width and depth
PREFILL_BATCH, PREFILL_SEQ = 1, 4096  # prefill_32k cut to one card
DECODE_BATCH, DECODE_CACHE, DECODE_TOKENS = 8, 32768, 8  # decode_32k cut
PARITY_LAYERS, PARITY_SEQ = 2, 256  # phase 8c: card against CPU, float32
PARITY_TOL = 1e-3  # max-abs on logits of magnitude ~1 (float32 both)
# the reference's flash-attention sweep (tests/test_kernels.py): (B, Hq,
# Hkv, Sq, Sk, D), causal; each run in float32 and bfloat16
ATTN_SWEEP = [((1, 2, 2, 128, 128, 64), True), ((2, 4, 2, 256, 256, 64), True),
              ((1, 8, 1, 100, 100, 32), False),
              ((1, 2, 1, 64, 192, 128), False), ((1, 4, 4, 1, 300, 64), False),
              ((1, 2, 2, 33, 65, 16), True)]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # max-abs, N(0, 1) inputs
# At the main path's own shapes (S = 4096) a causal row averages thousands
# of keys, so |o| is ~0.02-0.04 and 3e-2 would pass a wrong kernel: there
# both dtypes run, float32 within ATTN_TOL and bfloat16 elementwise within
# two bf16 steps of the plain version's value (2^-6 |want|) plus 1e-5 for
# the float32 sums' own differences before the one rounding.
ATTN_BF16_STEPS, ATTN_BF16_ABS = 2 ** -6, 1e-5
# phase 7b: shard counts, and the runs of DistributedEngine.run_batch as
# (interface, shards, owner masking)
SHARD_COUNTS = (4, 2)
SHARD_RUNS = (("spf", 4, True), ("brtpf", 4, True), ("endpoint", 4, True),
              ("tpf", 4, True), ("spf", 4, False), ("spf", 2, True))
# the largest lane capacity phase 7b runs: a query whose serial peak
# exceeds it (a star plan's cartesian product) is left out
SHARD_CAP_CEILING = 1 << 25
SHARD_OVERFLOW_CAP = 1024  # phase 7b's deliberately overflowing capacity


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


def scheduler_kernel_phase(torch, np, cuda):
    """The wave fingerprint and the cache-hit replay against their plain
    versions and host twins on the card, at the serving path's largest
    shapes (8 lanes of 2^20 rows); returns their report entries."""
    from repro_torch.core import fragcache
    from repro_torch.kernels import ref
    from repro_torch.kernels.fingerprint import (fingerprint_rows_cuda,
                                                 fingerprint_rows_plain)
    from repro_torch.kernels.replay import (replay_delta_cuda,
                                            replay_delta_plain)

    rng = np.random.default_rng(SEED + 2)
    i32 = np.iinfo(np.int32)
    lanes, cap = LANES, PROBE_QUERIES

    # ---- fingerprint: C = 3 read columns, int32 extremes and UNBOUND
    n_cols = 3
    blk = rng.integers(i32.min, i32.max, (lanes, cap, n_cols),
                       dtype=np.int64, endpoint=True).astype(np.int32)
    blk[:, :4, 0] = [-1, i32.min, i32.max, 0]
    blk[:, ::97, 1] = -1
    lens = [0, 1, 777, cap, -1, *rng.integers(2, cap, lanes - 5).tolist()]
    mask = np.zeros((lanes, cap), bool)
    for j, n in enumerate(lens):
        mask[j, :max(n, 0)] = True
    mask[4] = rng.random(cap) < 0.5  # not a prefix
    block = torch.from_numpy(blk).to(cuda)
    valid = torch.from_numpy(mask).to(cuda)
    got = fingerprint_rows_cuda(block, valid)
    want = fingerprint_rows_plain(block, valid)
    torch.cuda.synchronize()
    fp_err = max_abs_err(torch, [got], [want])
    check(fp_err == 0, "fingerprint_rows kernel == plain at 8 x 2^20 rows")
    digests = got.cpu().tolist()
    for j, n in enumerate(lens):
        if n >= 0:
            check(tuple(digests[j]) == ref.fingerprint_prefix_np(blk[j, :n]),
                  f"fingerprint_rows kernel == host twin, prefix {n}")
    empty = block[:, :, :0].contiguous()
    check(max_abs_err(torch, [fingerprint_rows_cuda(empty, valid)],
                      [fingerprint_rows_plain(empty, valid)]) == 0,
          "fingerprint_rows kernel == plain on a zero-column block")
    fp_ms = cuda_ms(torch, lambda: fingerprint_rows_cuda(block, valid))
    fp_plain = cuda_ms(torch, lambda: fingerprint_rows_plain(block, valid))
    n_valid = int(mask.sum())
    # bytes: every validity byte, the values of the valid rows only (the
    # kernel reads no other) counted in the 32-byte sectors that hold
    # them, and the digests out; ops: the hash of a valid row (10 per
    # column, 18 for the position, 40 for the four salted terms and sums)
    row_bytes = n_cols * 4
    first = np.flatnonzero(mask.ravel()) * row_bytes
    touched = np.zeros(-(-lanes * cap * row_bytes // SECTOR_BYTES), bool)
    for off in (*range(0, row_bytes, SECTOR_BYTES), row_bytes - 1):
        touched[(first + off) // SECTOR_BYTES] = True
    fp_values = int(touched.sum()) * SECTOR_BYTES
    fp_bound, fp_by = bound(lanes * cap + fp_values + lanes * 16,
                            n_valid * (10 * n_cols + 58))
    print(f"fingerprint_rows: {lanes} lanes x {cap} rows x {n_cols} cols, "
          f"{n_valid} valid (prefixes {lens[:4]} + random, one non-prefix "
          f"mask), max_abs_err {fp_err}, equal to the host twin; kernel "
          f"{fp_ms:.4f} ms, plain {fp_plain:.4f} ms, bound {fp_bound:.4f} ms "
          f"({fp_by}: {lanes * cap} mask bytes, {fp_values} value bytes in "
          f"the sectors of the valid rows, the digests); library: none (no "
          f"PyTorch call computes this hash)")

    # ---- replay: V = 6 columns, W = 2 written, M = cap source rows
    n_vars, write_cols = 6, (4, 1)
    seed_np = rng.integers(-1, 1 << 30, (lanes, cap, n_vars)).astype(np.int32)
    src_np = rng.integers(0, cap, (lanes, cap)).astype(np.int32)
    wr_np = rng.integers(0, 1 << 30, (lanes, cap, len(write_cols))
                         ).astype(np.int32)
    n_out_np = np.array([0, 1, cap, *rng.integers(2, cap, lanes - 3)],
                        np.int32)
    seed, src, written, n_out = (torch.from_numpy(a).to(cuda) for a in (
        seed_np, src_np, wr_np, n_out_np))
    args = (seed, src, written, n_out, write_cols)
    got = replay_delta_cuda(*args)
    want = replay_delta_plain(*args)
    torch.cuda.synchronize()
    rp_err = max_abs_err(torch, got, want)
    check(rp_err == 0, "replay_delta kernel == plain at 8 x 2^20 rows")
    j = 3
    k = int(n_out_np[j])
    rows, vmask = fragcache.replay(
        fragcache.FragmentEntry(src_np[j, :k], wr_np[j, :k], False, 0),
        seed_np[j], cap, n_vars, write_cols)
    check(np.array_equal(got[0][j].cpu().numpy(), rows)
          and np.array_equal(got[1][j].cpu().numpy(), vmask),
          "replay_delta kernel == fragcache.replay on one lane")
    rp_ms = cuda_ms(torch, lambda: replay_delta_cuda(*args))
    rp_plain = cuda_ms(torch, lambda: replay_delta_plain(*args))
    lane_idx = torch.arange(lanes, device=cuda)[:, None]
    rp_lib = cuda_ms(torch, lambda: seed[lane_idx, src])
    live = int(np.minimum(n_out_np, cap).sum())
    n_w = len(write_cols)
    # bytes: each live row's source index, written values and read
    # columns of its seed row once, the counts, and the whole output
    rp_bound, rp_by = bound(live * 4 * (1 + n_w + n_vars - n_w) + lanes * 4
                            + lanes * cap * (n_vars * 4 + 1), 0)
    print(f"replay_delta: {lanes} lanes x {cap} rows x {n_vars} cols, "
          f"{n_w} written, M={cap}, n_out {n_out_np.tolist()}, max_abs_err "
          f"{rp_err}, lane {j} equal to fragcache.replay; kernel "
          f"{rp_ms:.4f} ms, plain {rp_plain:.4f} ms, bound {rp_bound:.4f} ms "
          f"({rp_by}); library: the gather seed[lane, src] alone "
          f"{rp_lib:.4f} ms (a lower bound on the row gather, not the "
          f"replay; the port never calls it)")
    return [
        {"name": "fingerprint_rows", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fingerprint_rows.cu",
         "replaces": "src/repro/kernels/fingerprint.py:99",
         "launches": 0, "max_abs_err": fp_err, "ms": fp_ms,
         "plain_ms": fp_plain, "bound_ms": fp_bound, "bound_by": fp_by,
         "library_ms": None},
        {"name": "replay_delta", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/replay_delta.cu",
         "replaces": "src/repro/kernels/replay.py:100",
         "launches": 0, "max_abs_err": rp_err, "ms": rp_ms,
         "plain_ms": rp_plain, "bound_ms": rp_bound, "bound_by": rp_by,
         "library_ms": rp_lib},
    ]


def serving_phase(torch, np, core, store, loads, cuda):
    """Module docstring phase 7: the scheduler on the card under a
    16-client stream, held against the serial engine; returns the launch
    counts of drains 1 and 2 (the serving path)."""
    from repro_torch.kernels import ops
    from repro_torch.rdf.writes import WriteFeed

    class Logged(core.QueryScheduler):
        """Records each wave's (steps, host pulls, retries) deltas, its
        job count, and its fingerprint and replay launches."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.wave_log = []

        def _run_wave(self, jobs, results):
            m = self.metrics
            before = (m.steps, m.host_block_pulls, m.retries,
                      ops.LAUNCHES["fingerprint_rows"],
                      ops.LAUNCHES["replay_delta"])
            out = super()._run_wave(jobs, results)
            self.wave_log.append((m.steps - before[0],
                                  m.host_block_pulls - before[1],
                                  m.retries - before[2], len(jobs),
                                  ops.LAUNCHES["fingerprint_rows"] - before[3],
                                  ops.LAUNCHES["replay_delta"] - before[4]))
            return out

    def sync():
        torch.cuda.synchronize()

    queries = [q for qs in loads.values() for q in qs]
    stream = core.interleave_clients(queries, CLIENTS)
    cfg = core.EngineConfig()

    def serial_answers(engine_cfg):
        eng = core.QueryEngine(store, engine_cfg, device=cuda)
        return eng, {q: outcome(core, *eng.run(q)) for q in queries}

    def hold(reqs, served, want, what):
        check(len(served) == len(reqs), f"{what}: every request answered")
        for i, ((_, q), (tbl, stats)) in enumerate(zip(reqs, served)):
            check(outcome(core, tbl, stats) == want[q],
                  f"{what}: response {i} == serial")

    # ---- the answers to hold the scheduler against: the serial engine
    eng, want = serial_answers(cfg)
    t0 = time.perf_counter()
    for _, q in stream:
        eng.run(q)
    sync()
    t_serial = time.perf_counter() - t0
    print(f"serving: {len(queries)} distinct queries x {CLIENTS} clients = "
          f"{len(stream)} requests (interface spf, lanes {LANES}); the "
          f"serial QueryEngine.run loop over them (warm) {t_serial:.3f} s = "
          f"{len(stream) / t_serial:.1f} requests/s")

    # ---- drains 1 (cold) and 2 (warm) through one scheduler
    sched = Logged(store, cfg, core.SchedulerConfig(lanes=LANES),
                   device=cuda)
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    walls = []
    for d in (1, 2, 3):
        if d == 3:  # drains 1 and 2 are the serving path
            launches = dict(ops.LAUNCHES)
        m0, n_waves = sched.metrics.as_dict(), len(sched.wave_log)
        replays0 = ops.LAUNCHES["replay_delta"]
        t0 = time.perf_counter()
        served = sched.serve(stream)
        sync()
        wall = time.perf_counter() - t0
        walls.append(wall)
        hold(stream, served, want, f"drain {d}")
        delta = {k: v - m0[k] for k, v in sched.metrics.as_dict().items()}
        all_hit = [w for w in sched.wave_log[n_waves:] if w[0] == 0]
        check(all(pulls == retries for _, pulls, retries, *_ in all_hit),
              f"drain {d}: all-hit waves pull no table beyond retires")
        print(f"drain {d}: {wall:.3f} s = {len(stream) / wall:.1f} "
              f"requests/s; {delta}; {len(all_hit)} of "
              f"{len(sched.wave_log) - n_waves} waves all-hit; occupancy "
              f"{sched.metrics.occupancy:.3f}, pad_fraction "
              f"{sched.metrics.pad_fraction:.3f}, cache hit rate "
              f"{sched.cache.stats.hit_rate:.4f} (hits "
              f"{sched.cache.stats.hits}, shared {sched.cache.stats.shared_hits}"
              f", misses {sched.cache.stats.misses})")
        if d == 2:
            check(delta["steps_skipped"] > 0, "drain 2 replays units")
            check(ops.LAUNCHES["replay_delta"] > replays0,
                  "drain 2 launched the replay kernel")
        if d == 3:
            check(all_hit, "drain 3 has all-hit waves")
    check(launches["fingerprint_rows"] > 0 and launches["replay_delta"] > 0,
          "the serving path launched the fingerprint and replay kernels")
    check(sched.cache.stats.hits > 0, "the cache served hits")
    print(f"serving path (drains 1-2) kernel launches {launches}; drain 3 "
          f"{ {k: v - launches[k] for k, v in ops.LAUNCHES.items()} }")

    # ---- cache on, collapse off: 240 jobs in waves of 8, drained twice;
    # the digest and the replay run over 8 lanes that share keys
    wide = Logged(store, cfg, core.SchedulerConfig(
        lanes=LANES, collapse_duplicates=False), device=cuda)
    for d in (1, 2):
        m0, n_waves = wide.metrics.as_dict(), len(wide.wave_log)
        t0 = time.perf_counter()
        served = wide.serve(stream)
        sync()
        wall = time.perf_counter() - t0
        hold(stream, served, want, f"collapse off, drain {d}")
        delta = {k: v - m0[k] for k, v in wide.metrics.as_dict().items()}
        log = wide.wave_log[n_waves:]
        fp8 = sum(fp for *_, n, fp, _ in log if n == LANES)
        rp8 = sum(rp for *_, n, _, rp in log if n == LANES)
        check(delta["jobs"] == len(stream), f"collapse off, drain {d}: one "
              f"job per request")
        check(fp8 > 0, f"collapse off, drain {d}: fingerprint_rows launched "
              f"on {LANES}-lane waves")
        if d == 2:
            check(delta["steps_skipped"] > 0 and rp8 > 0,
                  f"collapse off, drain 2: replay_delta launched on "
                  f"{LANES}-lane waves")
        print(f"cache on, collapse off, drain {d}: {wall:.3f} s = "
              f"{len(stream) / wall:.1f} requests/s; {delta}; "
              f"{sum(n == LANES for _, _, _, n, _, _ in log)} of {len(log)} "
              f"waves {LANES} jobs wide, on which fingerprint_rows launched "
              f"{fp8} and replay_delta {rp8} times; hit rate "
              f"{wide.cache.stats.hit_rate:.4f} (hits {wide.cache.stats.hits}"
              f", shared {wide.cache.stats.shared_hits}, misses "
              f"{wide.cache.stats.misses})")
    check(wide.cache.stats.shared_hits > 0,
          "collapse off: lanes of one wave shared a key")

    # ---- cache off, collapse off, through QueryEngine.run_load
    eng_off = core.QueryEngine(store, cfg, device=cuda)
    off = core.QueryScheduler(store, cfg, core.SchedulerConfig(
        lanes=LANES, use_cache=False, collapse_duplicates=False),
        planner=eng_off.planner, device=cuda)
    t0 = time.perf_counter()
    tables, stats = eng_off.run_load([q for _, q in stream], scheduler=off)
    sync()
    t_off = time.perf_counter() - t0
    hold(stream, list(zip(tables, stats)), want, "cache off")
    check(off.metrics.jobs == len(stream) and off.cache.stats.hits == 0,
          "cache off: one job per request, no cache hit")
    tables, stats = eng_off.run_load(queries)
    hold([(0, q) for q in queries], list(zip(tables, stats)), want,
         "run_load")
    print(f"cache off, collapse off: {off.metrics.jobs} jobs in "
          f"{off.metrics.waves} waves, {t_off:.3f} s = "
          f"{len(stream) / t_off:.1f} requests/s, occupancy "
          f"{off.metrics.occupancy:.3f}, pad_fraction "
          f"{off.metrics.pad_fraction:.3f}; all equal to serial, and "
          f"QueryEngine.run_load's default scheduler too")

    # ---- the other interfaces, cache on, 4 clients
    for iface in ("tpf", "brtpf", "endpoint"):
        icfg = core.EngineConfig(interface=iface)
        _, iwant = serial_answers(icfg)
        isched = core.QueryScheduler(store, icfg, core.SchedulerConfig(
            lanes=LANES), device=cuda)
        istream = core.interleave_clients(queries, 4)
        t0 = time.perf_counter()
        served = isched.serve(istream)
        sync()
        hold(istream, served, iwant, iface)
        print(f"{iface}: {len(istream)} requests equal to serial in "
              f"{time.perf_counter() - t0:.3f} s, hit rate "
              f"{isched.cache.stats.hit_rate:.4f}")

    # ---- a write while serving, on the drains' scheduler
    one_star = loads["1-star"][0]
    read_preds = {t.p.id for t in one_star.patterns if not t.p.is_var}
    feed = WriteFeed(store, read_preds, rate=0.01, seed=SEED + 7)
    window = feed.next_window()
    rids = [sched.submit(q, client=c) for c, q in stream]
    sched.submit_write(**window)
    t0 = time.perf_counter()
    results = sched.drain()
    sync()
    t_write = time.perf_counter() - t0
    _, want_post = serial_answers(cfg)
    first = [results[r] for r in rids]
    hold(stream, first, want_post, "write")
    check(sched.cache.stats.carryover > 0 and sched.planner.stats.carryover
          > 0, "cache and planner entries carried over the write")
    again = sched.serve(stream)
    sync()
    hold(stream, again, want_post, "write, again")
    changed = sum(want_post[q] != want[q] for q in queries)
    # no answer holds a tombstoned triple
    r = np.int64(store.n_terms)
    tomb = np.array(sorted(store._tomb_set), np.int64).reshape(-1, 3)
    tomb_codes = (tomb[:, 0] * r + tomb[:, 1]) * r + tomb[:, 2]
    answered = {q: tbl for (_, q), (tbl, _) in zip(stream, first)}
    for q, tbl in answered.items():
        rows = core.results_as_numpy(tbl).astype(np.int64)
        for tp in q.patterns:
            s, p, o = (rows[:, t.id] if t.is_var else np.int64(t.id)
                       for t in (tp.s, tp.p, tp.o))
            codes = (p * r + s) * r + o
            check(not np.isin(codes, tomb_codes).any(),
                  "no answer holds a tombstoned triple")
    print(f"write while serving: {window['insert'][0].shape[0]} inserts + "
          f"{window['delete'][0].shape[0]} deletes on predicates "
          f"{sorted(read_preds)} + {feed.feed_preds.tolist()} applied at "
          f"wave boundary zero; drain {t_write:.3f} s; {len(stream)} "
          f"responses equal to serial on the post-write store twice "
          f"({changed} of {len(queries)} answers changed), none holds one "
          f"of the {tomb.shape[0]} tombstoned triples; carry-over: cache "
          f"{sched.cache.stats.carryover} entries (swept "
          f"{sched.cache.stats.swept}), planner "
          f"{sched.planner.stats.carryover} marks (swept "
          f"{sched.planner.stats.swept})")
    print(f"serving walls: serial loop {t_serial:.3f} s, drain 1 (cold) "
          f"{walls[0]:.3f} s, drain 2 (warm) {walls[1]:.3f} s, drain 3 "
          f"{walls[2]:.3f} s for {len(stream)} requests")
    return launches



def attention_operands(torch, gen, shape, dtype):
    """q, k, v of ``shape`` = (B, Hq, Hkv, Sq, Sk, D), N(0, 1) in ``dtype``
    on the generator's card, as the layers hand them over: transposed
    views of ``[B, S, H, D]`` projections."""
    b, hq, hkv, sq, sk, d = shape

    def one(h, s):
        x = torch.randn((b, s, h, d), generator=gen, device=gen.device)
        return x.to(dtype).transpose(1, 2)

    return one(hq, sq), one(hkv, sk), one(hkv, sk)


def attention_kernel_phase(torch, cuda):
    """Both attention kernels against their plain version on the card,
    through the dispatcher: the reference's sweep, the qwen2-7b prefill
    shape and a gemma-7b-shaped D = 256 case, each in float32 and
    bfloat16 — every bf16 case the wgmma rule admits goes to the wgmma
    kernel, every other case to the simple one, and each launch is
    checked to have gone where the rule sends it.  Then, on the bf16
    qwen2-7b operands and in turns, the wgmma kernel, the simple kernel
    called directly (held against the plain version too),
    ``scaled_dot_product_attention`` and the plain version are timed
    beside the bound.  Returns the report entries of the simple kernel
    and of the wgmma kernel."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (
        flash_attention_cuda, flash_attention_plain,
        flash_attention_simple_cuda, flash_attention_wgmma_cuda,
        wgmma_eligible)

    gen = torch.Generator(cuda).manual_seed(SEED + 3)
    cfg = lm_config()
    qwen = (PREFILL_BATCH, cfg.n_heads, cfg.n_kv, PREFILL_SEQ, PREFILL_SEQ,
            cfg.head_dim)
    gemma = (1, 16, 16, PREFILL_SEQ, PREFILL_SEQ, 256)
    cases = [(shape, causal) for shape, causal in ATTN_SWEEP]
    cases += [(qwen, True), (gemma, True)]
    worst = {"flash_attention": 0.0, "flash_attention_wgmma": 0.0}

    def hold(got, want, what, elementwise):
        """Hold ``got`` against ``want`` with the stated tolerances; return
        the max-abs error."""
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"attention output type at {what}")
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        dt = str(got.dtype).removeprefix("torch.")
        check(err < ATTN_TOL[dt], f"attention kernel == plain within "
              f"{ATTN_TOL[dt]} at {what}: {err}")
        note = ""
        if elementwise:
            step = ATTN_BF16_STEPS * want.float().abs() + ATTN_BF16_ABS
            ratio = float((diff / step).max())
            check(ratio <= 1.0, f"attention kernel == plain within "
                  f"{ATTN_BF16_STEPS:g} |want| + {ATTN_BF16_ABS:g} at "
                  f"{what}: {ratio:.3g} of it")
            note = (f", {ratio:.3g} of {ATTN_BF16_STEPS:g} |want| + "
                    f"{ATTN_BF16_ABS:g} (|want| mean "
                    f"{float(want.float().abs().mean()):.3g})")
        print(f"{what}: max_abs_err {err:.3g}{note}")
        return err

    for shape, causal in cases:
        for dt in ("float32", "bfloat16"):
            q, k, v = attention_operands(torch, gen, shape,
                                         getattr(torch, dt))
            name = ("flash_attention_wgmma" if wgmma_eligible(q, k, v)
                    else "flash_attention")
            check(dt == "float32" or shape[-1] not in (64, 128, 256)
                  or name == "flash_attention_wgmma",
                  f"the layers' bf16 view of {shape} meets the wgmma rule")
            before = dict(ops.LAUNCHES)
            got = flash_attention_cuda(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check(all(ops.LAUNCHES[n] == before[n] + (n == name)
                      for n in ops.LAUNCHES),
                  f"one launch of {name} and nothing else for {shape} {dt}")
            want = flash_attention_plain(q, k, v, causal=causal)
            err = hold(got, want, f"{name} {shape} causal={int(causal)} {dt}",
                       dt == "bfloat16" and shape in (qwen, gemma))
            if dt == "bfloat16":
                worst[name] = max(worst[name], err)
            del q, k, v, got, want

    q, k, v = attention_operands(torch, gen, qwen, torch.bfloat16)
    want = flash_attention_plain(q, k, v)
    err = hold(flash_attention_simple_cuda(q, k, v), want,
               f"flash_attention (called directly) {qwen} causal=1 bfloat16",
               True)
    worst["flash_attention"] = max(worst["flash_attention"], err)
    del want
    fns = {
        "flash_attention_wgmma": lambda: flash_attention_wgmma_cuda(q, k, v),
        "flash_attention": lambda: flash_attention_simple_cuda(q, k, v),
        "sdpa": lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
        "plain": lambda: flash_attention_plain(q, k, v),
    }
    iters = {"flash_attention_wgmma": 20, "flash_attention": 5, "sdpa": 20,
             "plain": 3}
    times = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:  # in turns: a b c d d c b a
        times[name].append(cuda_ms(torch, fns[name], iters=iters[name]))
    ms = {name: sum(t) / len(t) for name, t in times.items()}
    b, hq, hkv, sq, sk, d = qwen
    flops = 4 * b * hq * sq * sk * d / 2  # causal: half the scores
    nbytes = 2 * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
    t_ops = flops / BF16_TENSOR_FLOPS_S * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    fa_bound, fa_by = ((t_ops, "operations") if t_ops >= t_bytes
                       else (t_bytes, "bytes"))
    print(f"attention at the {LM_ARCH} prefill shape {qwen}, bf16, causal "
          f"(CUDA-event means, two turns each, a b c d d c b a); bound "
          f"{fa_bound:.4f} ms by {fa_by} ({flops:.3g} flops in "
          f"{t_ops:.4f} ms at the bf16 tensor peak, {nbytes / 1e6:.1f} MB "
          f"in {t_bytes:.4f} ms):")
    for name, t in ms.items():
        turns = ", ".join(f"{x:.4f}" for x in times[name])
        print(f"  {name}: {t:.4f} ms ({turns}), {flops / t / 1e9:.1f} "
              f"TFLOP/s, {t / fa_bound:.2f}x the bound, "
              f"{t / ms['sdpa']:.2f}x scaled_dot_product_attention")
    entries = []
    for name, source in (("flash_attention", "flash_attention.cu"),
                         ("flash_attention_wgmma",
                          "flash_attention_wgmma.cu")):
        entries.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:121",
            "launches": 0, "max_abs_err": worst[name], "ms": ms[name],
            "plain_ms": ms["plain"], "bound_ms": fa_bound,
            "bound_by": fa_by, "library_ms": ms["sdpa"]})
    return entries


def random_cache(torch, model, batch: int, seq: int, gen) -> dict:
    """A KV cache of ``seq`` positions with ``data.synth``'s distribution
    (normal times 0.02), drawn one layer at a time on the card: the
    synthetic batch would draw it as float64 on the host, ~60 GB at
    phase 8's decode shape."""
    cache = model.init_cache(batch, seq)
    for t in cache.values():
        for layer in t:
            layer.copy_(torch.randn(layer.shape, generator=gen,
                                    device=layer.device) * 0.02)
    return cache


def lm_config(**overrides):
    """The served model's config, as its cells build it."""
    from repro_torch.configs.steps import build_cell

    return build_cell(LM_ARCH, "prefill_32k", overrides=overrides).model_cfg


def lm_serving_phase(torch, cuda):
    """qwen2-7b at its published width and depth on the card: a prefill
    through the ``prefill_32k`` cell, then greedy decode steps as the
    launcher runs them, each with the launch counts set to 0 just before
    and read just after.  Returns the prefill's launch counts."""
    from repro_torch.configs.steps import build_cell
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.serving import make_decode_step

    cell = build_cell(LM_ARCH, "prefill_32k")
    cfg = cell.model_cfg
    gen = torch.Generator(cuda).manual_seed(SEED)
    with torch.inference_mode():
        t0 = time.perf_counter()
        model = Transformer(cfg, device=cuda, generator=gen)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv} heads of {cfg.head_dim}, d_ff "
              f"{cfg.d_ff}, vocab {cfg.vocab}: {n_params} parameters "
              f"({n_params * 2 / 1e9:.2f} GB bf16) built on the card in "
              f"{time.perf_counter() - t0:.1f} s")
        check(n_params > 7.0e9, "qwen2-7b at its published width")

        tokens = torch.randint(0, cfg.vocab, (PREFILL_BATCH, PREFILL_SEQ),
                               generator=gen, device=cuda, dtype=torch.int32)
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        logits = cell.fn(model, {"tokens": tokens})
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        check(tuple(logits.shape) == (PREFILL_BATCH, PREFILL_SEQ, cfg.vocab),
              "prefill logits shape")
        check(bool(torch.isfinite(logits).all()), "prefill logits finite")
        check(launches["flash_attention_wgmma"] == cfg.n_layers
              and sum(launches.values()) == cfg.n_layers,
              f"one wgmma attention launch per layer and no other kernel: "
              f"{launches}")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            logits = cell.fn(model, {"tokens": tokens})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"prefill B={PREFILL_BATCH} S={PREFILL_SEQ}: logits "
              f"{tuple(logits.shape)} finite, launches {launches}; wall "
              f"{cold * 1e3:.1f} ms cold, warm "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms")
        del logits

        t0 = time.perf_counter()
        cache = random_cache(torch, model, DECODE_BATCH, DECODE_CACHE, gen)
        token = torch.randint(0, cfg.vocab, (DECODE_BATCH,), generator=gen,
                              device=cuda, dtype=torch.int32)
        torch.cuda.synchronize()
        cache_gb = sum(t.numel() * t.element_size()
                       for t in cache.values()) / 1e9
        print(f"decode: cache {DECODE_BATCH} x {DECODE_CACHE} positions, "
              f"{cache_gb:.2f} GB bf16, filled on the card in "
              f"{time.perf_counter() - t0:.1f} s")
        step = make_decode_step(cell.family, cfg)
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        secs = []
        for r in range(2):
            token, logits, dt = greedy_decode(
                model, step, token, cache,
                DECODE_CACHE // 2 + r * DECODE_TOKENS, DECODE_TOKENS)
            secs.append(dt)
            check(tuple(logits.shape) == (DECODE_BATCH, cfg.vocab)
                  and bool(torch.isfinite(logits).all()),
                  "decode logits finite, [B, V]")
        check(sum(ops.LAUNCHES.values()) == 0,
              f"decode launched no kernel: {ops.LAUNCHES}")
        print(f"decode: {DECODE_TOKENS} greedy steps, batch {DECODE_BATCH}, "
              f"twice: {secs[0] * 1e3 / DECODE_TOKENS:.2f} ms/token (first), "
              f"{secs[1] * 1e3 / DECODE_TOKENS:.2f} ms/token (second); peak "
              f"{torch.cuda.max_memory_allocated(cuda) / 1e9:.1f} GB "
              f"allocated")
        del model, cache, logits
    torch.cuda.empty_cache()
    return launches


def lm_parity_phase(torch, cuda):
    """qwen2-7b at full width with ``PARITY_LAYERS`` layers in float32, the
    same weights on the CPU (plain attention) and on the card (the simple
    kernel: float32 is outside the wgmma rule): logits within
    ``PARITY_TOL`` and the same argmax at every position.  Returns the
    card forward's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Transformer

    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 products on the card in full float32 (no TF32)")
    cfg = lm_config(n_layers=PARITY_LAYERS, dtype="float32")
    gen = torch.Generator("cpu").manual_seed(SEED)
    with torch.inference_mode():
        model = Transformer(cfg, device="cpu", generator=gen)
        tokens = torch.randint(0, cfg.vocab, (1, PARITY_SEQ), generator=gen,
                               dtype=torch.int32)
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        on_cpu = model(tokens)
        t_cpu = time.perf_counter() - t0
        check(sum(ops.LAUNCHES.values()) == 0, "no kernel on the CPU path")
        model.to(cuda)
        on_card = model(tokens.to(cuda))
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        check(launches["flash_attention"] == PARITY_LAYERS
              and sum(launches.values()) == PARITY_LAYERS,
              f"the card's float32 forward went through the simple kernel "
              f"once per layer: {launches}")
        on_card = on_card.cpu()
        err = float((on_card - on_cpu).abs().max())
        top2 = on_cpu.topk(2, dim=-1).values
        gap = float((top2[..., 0] - top2[..., 1]).min())
        same = int((on_card.argmax(-1) == on_cpu.argmax(-1)).sum())
        print(f"parity: {LM_ARCH} full width, {PARITY_LAYERS} layers, "
              f"float32, S={PARITY_SEQ}: card vs CPU logits max_abs_err "
              f"{err:.3g} (tolerance {PARITY_TOL}, |logits| max "
              f"{float(on_cpu.abs().max()):.3g}), argmax equal at {same} of "
              f"{PARITY_SEQ} positions (smallest top-2 gap {gap:.3g}); CPU "
              f"forward {t_cpu:.1f} s")
        check(err <= PARITY_TOL, "card logits == CPU logits within tolerance")
        check(same == PARITY_SEQ, "the same argmax at every position")
        del model, on_card, on_cpu
    torch.cuda.empty_cache()
    return launches


def owned_kernel_phase(torch, np, store, stacked):
    """The owner-masked probe against its plain version on the card, at
    the sharded path's largest shape (2^20 bound-subject rows against
    shard 0's PSO key column at 4 shards, every ``my_shard``) and at the
    edges; returns its report entry (launches filled in later)."""
    from repro_torch.kernels.owned_probe import (eqrange_owned_cuda,
                                                 eqrange_owned_plain)

    rng = np.random.default_rng(SEED + 3)
    n_shards = stacked.key_ps_pso.shape[0]
    keys = stacked.key_ps_pso[0]
    cuda = keys.device
    n, q = keys.shape[0], PROBE_QUERIES
    # rows drawn from the store: (p, s) keys with their subjects, so each
    # shard owns about 1/n_shards of them
    pick = rng.integers(0, store.n_base, q)
    queries = torch.from_numpy(store.h_key_ps[pick]).to(cuda)
    subjects = torch.from_numpy(store.h_s_pso[pick].astype(np.int64)).to(cuda)
    err, owned = 0, []
    for my in range(n_shards):
        got = eqrange_owned_cuda(keys, queries, subjects, my, n_shards)
        want = eqrange_owned_plain(keys, queries, subjects, my, n_shards)
        torch.cuda.synchronize()
        err = max(err, max_abs_err(torch, got, want))
        owned.append(int(got[2].sum()))
    check(err == 0, "eqrange_owned kernel == plain at 2^20 rows, every shard")
    check(sum(owned) == q and all(0.2 * q < c < 0.3 * q for c in owned),
          f"each of {n_shards} shards owns about a quarter of the rows")
    # the edges: int64-extreme queries and subjects, one shard (all
    # owned), shard counts past the reference's 4096, an empty column and
    # batch, a row count that fills no block
    i64 = np.iinfo(np.int64)
    small = np.array([i64.min, -7, 3, 3, 9, i64.max], np.int64)
    qs = np.concatenate([small, rng.integers(-10, 12, 994), [i64.max]])
    subj = np.concatenate([[0, -1, i64.min, i64.max, i64.min + 1, 2**32],
                           rng.integers(i64.min, i64.max, 995,
                                        dtype=np.int64)])
    n_edges = 0
    for k in (small, small[:0]):
        for my, ns in ((0, 1), (2, 4), (5, 4097), (9, 10007)):
            for m in (len(qs), 0):
                args = [torch.from_numpy(a[:m]) for a in (k, qs, subj)]
                args[0] = torch.from_numpy(k)
                got = eqrange_owned_cuda(*(a.to(cuda) for a in args), my, ns)
                want = eqrange_owned_plain(*args, my, ns)
                check(max_abs_err(torch, [g.cpu() for g in got], want) == 0,
                      f"eqrange_owned kernel == plain at the edges "
                      f"(n={len(k)}, q={m}, shards={ns})")
                check(ns != 1 or bool(got[2].all()), "one shard owns all")
                n_edges += 1
    ms = cuda_ms(torch, lambda: eqrange_owned_cuda(keys, queries, subjects,
                                                   0, n_shards))
    plain = cuda_ms(torch, lambda: eqrange_owned_plain(keys, queries,
                                                       subjects, 0, n_shards))
    lib = cuda_ms(torch, lambda: (
        torch.searchsorted(keys, queries, side="left", out_int32=True),
        torch.searchsorted(keys, queries, side="right", out_int32=True)))
    logn = math.ceil(math.log2(n))
    # bytes: the column, the queries and subjects, and lo, hi and owned
    # once; operations: the hash of every row (about a dozen integer
    # operations), every row's lower bisection and the owned rows' upper
    b_ms, b_by = bound(n * 8 + q * (8 + 8) + q * (4 + 4 + 1),
                       q * (12 + logn) + owned[0] * logn)
    print(f"eqrange_owned: n={n} (shard 0 of {n_shards}) q={q}, owned by "
          f"shard {owned}, max_abs_err {err} over every shard and {n_edges} "
          f"edge cases; kernel {ms:.4f} ms (my_shard 0), plain "
          f"{plain:.4f} ms, torch.searchsorted x2 {lib:.4f} ms (a lower "
          f"bound: no PyTorch call computes the hash), bound {b_ms:.4f} ms "
          f"({b_by})")
    return {"name": "eqrange_owned", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/eqrange_owned.cu",
            "replaces": "src/repro/kernels/owned_probe.py:179",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def unit_peaks(torch, core, store, q, interface, device) -> int:
    """The largest branch-boundary row count of ``q``'s serial evaluation
    under ``interface`` (every unit's ``eval_unit`` peak), found at caps
    growing 4x from 2^20; ``SHARD_CAP_CEILING + 1`` where even the
    ceiling overflows."""
    from repro_torch.core import bindings, server

    plan = core.engine.plan_query(store, q, core.EngineConfig(
        interface=interface))
    dev = store.device_arrays(device)
    const_vec = torch.tensor(plan.consts, dtype=torch.int64, device=device)
    logn = server.log_factor(store.n_triples)
    cap = PROBE_QUERIES
    while True:
        table = bindings.unit_table(cap, max(plan.n_vars, 1), device=device)
        peak = 1
        for up in plan.units:
            table, _, p = server.eval_unit(dev, store.radix, up, const_vec,
                                           table, logn=logn)
            peak = max(peak, int(p))
        if not bool(table.overflow):
            return peak
        if cap >= SHARD_CAP_CEILING:
            return SHARD_CAP_CEILING + 1
        cap = min(cap * 4, SHARD_CAP_CEILING)


def sharded_plan(torch, core, store, loads, interfaces, device):
    """Per (interface, load): the queries whose serial peak fits under
    ``SHARD_CAP_CEILING`` and the load's cap — the smallest power of two
    holding every unit's peak of those queries — plus the serial
    ``QueryEngine.run`` answers on the card (``max_cap`` raised to that
    cap), their warm walls and their peaks."""
    peaks: dict = {}
    plan = {}
    for iface in interfaces:
        for load, qs in loads.items():
            keep, need, kept_peaks = [], 1, []
            for i, q in enumerate(qs):
                p = core.engine.plan_query(store, q, core.EngineConfig(
                    interface=iface))
                key = (p.units, p.consts)  # SPF == endpoint, TPF == brTPF
                if key not in peaks:
                    peaks[key] = unit_peaks(torch, core, store, q, iface,
                                            device)
                if peaks[key] <= SHARD_CAP_CEILING:
                    keep.append(i)
                    kept_peaks.append(peaks[key])
                    need = max(need, peaks[key])
            cap = 1 << (need - 1).bit_length()
            eng = core.QueryEngine(store, core.EngineConfig(
                interface=iface, max_cap=max(cap, PROBE_QUERIES)),
                device=device)
            answers, wall = [], 0.0
            for i in keep:
                eng.run(qs[i])
                t0 = time.perf_counter()
                tbl, stats = eng.run(qs[i])
                answers.append((core.results_as_numpy(tbl),
                                int(stats.n_results), bool(stats.overflow)))
                torch.cuda.synchronize()
                wall += time.perf_counter() - t0
            check(not any(a[2] for a in answers),
                  f"serial {iface} {load}: nothing overflows at cap {cap}")
            plan[(iface, load)] = (keep, cap, answers, wall, kept_peaks)
    return plan


def sharded_runs(torch, core, store, loads, plan, runs, cuda, what):
    """Each ``(interface, n_shards, owner_masking)`` of ``runs``: every
    load's kept queries as one ``run_batch`` per load on the card at the
    load's cap, each lane held to the serial answer.  Returns the launch
    counts by run."""
    from repro_torch.core.distributed import DistConfig, DistributedEngine
    from repro_torch.kernels import ops

    out = {}
    for iface, n_shards, owner in runs:
        for name in ops.LAUNCHES:
            ops.LAUNCHES[name] = 0
        t0 = time.perf_counter()
        n_q, serial_wall = 0, 0.0
        for load, qs in loads.items():
            keep, cap, answers, wall, _ = plan[(iface, load)]
            eng = DistributedEngine(
                store, core.EngineConfig(interface=iface),
                DistConfig(cap=cap, shard_cap=cap, owner_masking=owner),
                n_shards=n_shards, device=cuda)
            rows, valid, stats = eng.run_batch([qs[i] for i in keep])
            for lane, (want, count, _) in enumerate(answers):
                got = rows[lane][valid[lane]].cpu().numpy()
                st = [int(f[lane]) for f in stats] \
                    if not isinstance(rows, list) \
                    else [int(x) for x in stats[lane]]
                check(got.tobytes() == want.tobytes() and got.shape ==
                      want.shape, f"{what} {iface} {n_shards} shards "
                      f"owner={owner} {load} #{keep[lane]}: run_batch == "
                      f"serial")
                check(st[4] == count and st[5] == 0,
                      f"{what} {iface} {load} #{keep[lane]}: n_results and "
                      f"no overflow")
            n_q += len(keep)
            serial_wall += wall
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        check((counts["eqrange_owned"] > 0) == owner,
              f"{what} {iface} {n_shards} shards: the owner-masked probe "
              f"launches iff owner masking is on")
        out[(iface, n_shards, owner)] = counts
        print(f"sharded {what}: {iface:8s} {n_shards} shards owner="
              f"{int(owner)}: {n_q} queries equal the serial engine, "
              f"run_batch {t_run:.3f} s ({t_run / n_q * 1e3:.1f} ms/query; "
              f"serial warm {serial_wall / n_q * 1e3:.1f} ms/query, "
              f"{t_run / serial_wall:.1f}x), launches {counts}")
    return out


def sharded_phase(torch, np, core, store, loads, cuda):
    """Module docstring phase 7b: the subject-hash-sharded store and
    ``DistributedEngine.run_batch`` on the card; returns the owner-masked
    probe's report entry with its launches on the sharded path."""
    from repro_torch.core.distributed import DistConfig, DistributedEngine
    from repro_torch.kernels import ops

    check(store.delta_size > 0, "phase 7's write left a delta")
    stacked = {}
    for n_shards in SHARD_COUNTS:
        t0 = time.perf_counter()
        shards = store.shard_by_subject(n_shards)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        stacked[n_shards] = store.stacked_shard_arrays(n_shards, cuda)
        torch.cuda.synchronize()
        check(all(s._ins_set and s._tomb_set for s in shards),
              f"every one of {n_shards} shards holds inserts and tombstones")
        print(f"sharded: {n_shards} shards of {shards[0].n_base} base "
              f"triples (padded) built in {t_build:.1f} s, uploaded in "
              f"{time.perf_counter() - t0:.2f} s; delta per shard "
              f"{[s.delta_size for s in shards]}")
    entry = owned_kernel_phase(torch, np, store, stacked[4])
    interfaces = sorted({r[0] for r in SHARD_RUNS})
    t0 = time.perf_counter()
    plan = sharded_plan(torch, core, store, loads, interfaces, cuda)
    caps = ", ".join(f"{i}/{load} {p[1]}" for (i, load), p in plan.items())
    print(f"sharded: the loads' caps: {caps}; queries kept {sum(len(k) for k, *_ in plan.values())} of "
          f"{len(interfaces) * sum(map(len, loads.values()))} (serial "
          f"peaks above {SHARD_CAP_CEILING} rows left out), planned in "
          f"{time.perf_counter() - t0:.1f} s")
    launches = sharded_runs(torch, core, store, loads, plan, SHARD_RUNS,
                            cuda, "with a delta")
    entry["launches"] = sum(c["eqrange_owned"] for c in launches.values())

    # ---- DistStats against the CPU: one query per load, and an overflow
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    cases = []
    for load in loads:
        keep, _, _, _, kept_peaks = plan[("spf", load)]
        # the load's query with the smallest peak, at the smallest cap
        # holding it (the CPU run stays short)
        j = min(range(len(keep)), key=lambda k: kept_peaks[k])
        cap = 1 << (kept_peaks[j] - 1).bit_length()
        cases.append((f"{load} #{keep[j]}", loads[load][keep[j]], cap, cap))
    cases.append(("1-star #0, overflowing", loads["1-star"][0],
                  SHARD_OVERFLOW_CAP, SHARD_OVERFLOW_CAP))
    for label, q, cap, shard_cap in cases:
        dcfg = DistConfig(cap=cap, shard_cap=shard_cap, owner_masking=True)
        card = DistributedEngine(store, core.EngineConfig(), dcfg,
                                 n_shards=4, device=cuda).run_batch([q])
        torch.cuda.synchronize()
        before = dict(ops.LAUNCHES)
        host = DistributedEngine(store, core.EngineConfig(), dcfg,
                                 n_shards=4, device="cpu").run_batch([q])
        check(ops.LAUNCHES == before, "no kernel launched on the CPU path")
        for g, w in zip(card[:2], host[:2]):
            check(torch.equal(g.cpu(), w), f"card == CPU rows and valid for "
                  f"{label}")
        st_card = [int(f[0]) for f in card[2]]
        check(st_card == [int(f[0]) for f in host[2]],
              f"card == CPU DistStats for {label}")
        check(bool(st_card[5]) == (cap == SHARD_OVERFLOW_CAP),
              f"{label}: overflow as expected")
        print(f"sharded: {label} at cap {cap}, 4 shards, owner masking: "
              f"card == CPU in rows, valid and DistStats {st_card}")
    print(f"sharded: {len(cases)} card runs held against the CPU in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- the same without a delta: undo phase 7's write (tombstoned
    # triples back in, inserted ones out), so the shards keep their base
    base_ptrs = {n: [t.data_ptr() for t in stacked[n][:6]]
                 for n in SHARD_COUNTS}
    ins = np.array(sorted(store._ins_set), np.int64).reshape(-1, 3)
    tomb = np.array(sorted(store._tomb_set), np.int64).reshape(-1, 3)
    t0 = time.perf_counter()
    store.apply_delta(insert=(tomb[:, 1], tomb[:, 0], tomb[:, 2]),
                      delete=(ins[:, 1], ins[:, 0], ins[:, 2]))
    check(store.delta_size == 0, "the undo leaves no delta")
    for n_shards in SHARD_COUNTS:
        arrays = store.stacked_shard_arrays(n_shards, cuda)
        check([t.data_ptr() for t in arrays[:6]] == base_ptrs[n_shards],
              f"{n_shards} shards keep their base tensors")
        check(all(t.shape[1] == 0 for t in arrays[6:]),
              f"{n_shards} shards hold no delta")
    print(f"sharded: delta undone in {time.perf_counter() - t0:.2f} s")
    runs = [r for r in SHARD_RUNS if r[0] == "spf"]
    plan = sharded_plan(torch, core, store, loads, ["spf"], cuda)
    launches = sharded_runs(torch, core, store, loads, plan, runs, cuda,
                            "without a delta")
    entry["launches"] += sum(c["eqrange_owned"] for c in launches.values())
    return entry


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
    sched_report = scheduler_kernel_phase(torch, np, cuda)
    torch.cuda.empty_cache()
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

    # ---- 7. serving: the scheduler on the compacted store
    t_phase = time.perf_counter()
    serve_launches = serving_phase(torch, np, core, store, loads, cuda)
    for entry in sched_report:
        entry["launches"] = serve_launches[entry["name"]]
        check(entry["launches"] > 0, f"{entry['name']} ran on the serving "
              f"path")
    report += sched_report
    phases["7 serving"] = time.perf_counter() - t_phase

    # ---- 7b. the sharded store and DistributedEngine.run_batch
    t_phase = time.perf_counter()
    report.insert(3, sharded_phase(torch, np, core, store, loads, cuda))
    phases["7b sharded"] = time.perf_counter() - t_phase

    # ---- 8. LM serving: qwen2-7b on the card, its attention kernel
    t_phase = time.perf_counter()
    del dev, store, g, loads, on_card, on_cpu
    gc.collect()
    torch.cuda.empty_cache()
    simple, wgmma = attention_kernel_phase(torch, cuda)
    wgmma["launches"] = lm_serving_phase(torch, cuda)["flash_attention_wgmma"]
    simple["launches"] = lm_parity_phase(torch, cuda)["flash_attention"]
    report += [simple, wgmma]
    phases["8 LM serving"] = time.perf_counter() - t_phase
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
