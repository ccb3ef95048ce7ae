"""Concurrent query scheduler: mixed loads as batched, cache-aware work.

The paper's headline result is throughput under concurrent load (up to 128
clients), so the serving path must *be* a load server, not a serial loop.
This module accepts an interleaved stream of queries from N simulated
clients and turns it into device work:

1. **Bucket** — requests are planned (memoised per query) and grouped by
   plan signature; identical in-flight ``(signature, constants)`` requests
   collapse onto one job whose response is fanned out (request collapsing,
   the concurrent analogue of a cache hit).  Starting capacities are
   data-informed: the capacity planner (``core/capacity.py``) serves the
   high-water mark last observed for the query (epoch-tagged) or the
   degree oracle's bound for cold plans, so warm loads never climb the 4x
   ladder.
2. **Pad** — each bucket is cut into waves of at most ``lanes`` jobs; a
   wave runs at the smallest power-of-two lane width that fits it and is
   padded with no-op lanes (empty seed table, zero constants).
3. **Dispatch** — a wave executes unit by unit through the wave step
   (``stepper.unit_step``).  The JAX reference lowers it as
   ``jit(vmap(lane_fn))``; here the same per-lane evaluator runs lane by
   lane on the card and the outputs are stacked, and lanes nothing reads
   (padding, retired lanes) are not evaluated.  Wave state stays
   device-resident between steps: per unit only per-lane digests, counts
   and flags cross to the host.
4. **Cache** — between unit steps the scheduler fingerprints every lane's
   seeded request *on the device* (one ``kops.fingerprint_rows`` launch
   per wave over the valid prefix of the unit's read columns) and
   consults the star-fragment cache (``core/fragcache.py``) with the
   digest-form key (``server.unit_digest_key``, tagged with the store
   epoch): the Omega block never goes to the host just to be hashed into
   a key.  Replay runs on the device too (one ``kops.replay_delta``
   launch per wave): when every active lane hits, the cached
   fragment deltas — the small objects — are uploaded and scattered onto
   the lanes' seed tables, so an all-hit wave pulls **no** table to the
   host (``SchedMetrics.host_block_pulls`` counts the exceptions: a miss
   pulls its lane's output prefix to record the replayable delta, an
   overflow-retire pulls its checkpoint seed).  Exact per-query savings
   land in ``QueryStats`` (``cache_hits``/``cache_misses``/
   ``nrs_saved``/``ntb_saved``).  One cache and one planner may be shared
   by any number of schedulers; a store write bumps ``TripleStore.epoch``
   and the next drain sweeps them, carrying over the entries over
   predicates the write did not touch.

Provenance: unit steps carry an extra int32 table column seeded with the
row index, so the scheduler can read each output row's source row off the
result — that is what makes computed fragments replayable as deltas
without re-deriving join provenance on the host.

Capacity overflow is *resumable*: when a lane overflows at unit k, only
that query is requeued — re-bucketed under ``(signature, 4x cap, unit k)``
with the checkpointed pre-step table as its seed and its cost account
carried over, so units 0..k-1 are never re-executed.  Results stay
byte-identical to the serial path: a non-overflowing unit's valid rows
and cost account are independent of the capacity (and seed capacity) it
ran at.  Stats match the serial engine's exactly on the gross fields
(``stepper.unit_cost`` mirrors ``engine._execute``).

Writes (``submit_write`` / ``ingest``) land at wave boundaries; a job
keeps the store view it started on (``_EpochView``) for its overflow
retries, so no query mixes two epochs.

This is the single-host part of the JAX reference's scheduler
(``core/scheduler.py``): the mesh and sharded lowerings, the fault plane
and the span tracer are not part of this package yet.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Iterable, NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import stepper
from repro_torch.core.bindings import BindingTable
from repro_torch.core.capacity import CapacityPlanner
from repro_torch.core.engine import (EngineConfig, QueryPlan, QueryStats,
                                     plan_query)
from repro_torch.core.fragcache import FragmentCache, FragmentEntry
from repro_torch.core.patterns import BGP
from repro_torch.core.server import log_factor, unit_digest_key, unit_io
from repro_torch.kernels import ops as kops
from repro_torch.rdf.store import StoreArrays, TripleStore, resolve_device


@dataclass(frozen=True)
class SchedulerConfig:
    # max lane width of a dispatched wave; a wave runs at the smallest
    # power-of-two width that fits its jobs (so a 1-job overflow-retry wave
    # at a huge cap is not padded 8-wide), padded with no-op lanes
    lanes: int = 8
    use_cache: bool = True
    cache_entries: int = 4096
    # collapse identical in-flight (signature, constants) requests onto one
    # lane; their shared response counts as cache-served for the duplicates
    collapse_duplicates: bool = True
    # start jobs at planner-informed capacities (HWM or degree oracle when
    # the engine config enables the planner; the per-scheduler final-cap
    # memo otherwise) instead of cfg.cap — re-submissions jump straight to
    # the last observed rung (results are byte-identical)
    cap_hints: bool = True


class Request(NamedTuple):
    rid: int
    client: int
    query: BGP
    # absolute time.perf_counter() deadline, or None (no deadline); checked
    # at unit-step boundaries — an expired request resolves as
    # (None, stats-so-far) instead of burning the rest of its wave
    deadline: float | None = None


class _EpochView(NamedTuple):
    """One store epoch's device-resident serving snapshot.

    A wave pins the view it starts on (``_Job.view``), and overflow
    retries carry the pin — so a write applied between waves
    (``submit_write`` → ``_apply_writes``) never mixes epochs inside one
    query execution: in-flight jobs finish on the old epoch's tensors
    (the pin keeps them alive; ``TripleStore.device_arrays`` makes new
    tensors for a new epoch and never writes into old ones), fresh waves
    pick up the new epoch.  ``logn``/``probe_ops`` ride along because the
    cost account derives from the *logical* triple count, which moves
    with every delta epoch.
    """

    epoch: int
    dev: StoreArrays
    logn: int
    probe_ops: int


@dataclass
class _Job:
    """One distinct query execution: a lane's worth of work at one cap.

    A resumable overflow retry re-enters at ``resume_k`` with ``seed`` (the
    checkpointed valid-prefix rows of the overflowed unit's input) and the
    cost account ``acc`` accumulated over units 0..resume_k-1.
    """

    plan: QueryPlan
    consts: tuple[int, ...]
    cap: int
    rids: list[int]
    resume_k: int = 0
    seed: np.ndarray | None = None
    acc: "_LaneAcc | None" = None
    # largest true per-unit peak row count seen so far (carried across
    # resume retries) — what observe_query records as the query's need
    peak_seen: int = 1
    # the epoch view this job's first wave served on (pinned for retries;
    # None until the job has run — fresh jobs adopt the current epoch)
    view: _EpochView | None = None


class SchedMetrics(obs.RegistryView):
    """Scheduler tallies as ``sched.*`` instruments in one
    ``MetricsRegistry``.  A scheduler's cache and planner mount their
    ``cache.*`` / ``planner.*`` instruments on the same registry, so one
    ``QueryScheduler.snapshot()`` covers the whole serving stack."""

    _PREFIX = "sched"
    _FIELDS = (
        "requests",
        "jobs",  # distinct executions after collapsing
        "waves",
        "steps",  # device unit-steps dispatched
        "steps_skipped",  # unit-steps fully served by the cache
        "lane_steps",  # lanes x dispatched steps (incl. padding)
        "active_lane_steps",  # non-padding lanes among those
        "retries",  # jobs requeued (resumably) at 4x cap
        # requests expired at a unit-step boundary: answered
        # (None, stats-so-far)
        "deadline_expired",
        # Omega-block device->host pulls during unit stepping
        # (miss-insertion prefix pulls + overflow-retire checkpoints;
        # finalize excluded).  The device-replay invariant the tests pin:
        # an all-hit wave adds zero.
        "host_block_pulls",
    )

    @property
    def occupancy(self) -> float:
        """Mean active (non-padding) lanes per dispatched device step."""
        return self.active_lane_steps / self.steps if self.steps else 0.0

    @property
    def pad_fraction(self) -> float:
        if not self.lane_steps:
            return 0.0
        return 1.0 - self.active_lane_steps / self.lane_steps


def interleave_clients(queries: list[BGP], n_clients: int
                       ) -> list[tuple[int, BGP]]:
    """The paper's load setup as an arrival stream: every client executes
    the load in order; arrivals interleave round-robin across clients."""
    return [(c, q) for q in queries for c in range(n_clients)]


@dataclass
class _LaneAcc:
    """Per-lane stats accumulator, carried across resume retries."""

    nrs: int = 0
    ntb: int = 0
    server: int = 0
    client: int = 0
    hits: int = 0
    misses: int = 0
    nrs_saved: int = 0
    ntb_saved: int = 0


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------

class QueryScheduler:
    """Serve a mixed query stream through signature buckets + fragment cache.

    ``run_queries`` is the drop-in for ``QueryEngine.run_load``; ``submit``
    + ``drain`` expose the request-stream form for simulated-client loads.
    One scheduler owns one store + engine config; the fragment cache and
    the capacity planner can be shared across schedulers by passing them
    in.  ``device`` is where the waves run: the card unless the caller
    passes ``device="cpu"``.  Responses are host tensors.
    """

    def __init__(self, store: TripleStore, cfg: EngineConfig,
                 scfg: SchedulerConfig | None = None,
                 cache: FragmentCache | None = None,
                 planner: CapacityPlanner | None = None,
                 registry: obs.MetricsRegistry | None = None,
                 device=None):
        self.store = store
        self.cfg = cfg
        self.scfg = scfg or SchedulerConfig()
        self.device = resolve_device(device)
        # one registry per scheduler: SchedMetrics plus the cache./
        # planner. instruments of components this scheduler constructs
        # itself all mount here, so snapshot() covers the serving stack.
        # Shared caches/planners passed in keep their own registries.
        self.registry = registry if registry is not None \
            else obs.MetricsRegistry()
        self.cache = cache if cache is not None else \
            FragmentCache(capacity=self.scfg.cache_entries,
                          registry=self.registry)
        self.planner = planner if planner is not None \
            else CapacityPlanner(store, cfg, registry=self.registry,
                                 device=self.device)
        self.metrics = SchedMetrics(self.registry)
        self._t_submit: dict[int, float] = {}  # obs-only request walls
        self._deadlines: dict[int, float] = {}  # rid -> absolute deadline
        self._plan_memo: dict[BGP, QueryPlan] = {}
        self._cap_hints: dict[tuple, int] = {}  # final-cap memo (planner off)
        self._pending: list[Request] = []
        self._next_rid = 0
        n = store.n_triples
        self._logn = log_factor(n)
        # TPF page-accounting charges the probe primitive's cost (these
        # refresh per epoch — the logical triple count moves with every
        # delta batch)
        self._probe_ops = kops.probe_op_cost(n)
        self._cost_epoch = store.epoch
        self._writes: list[tuple] = []  # queued (insert, delete) batches
        self._draining = False

    # ------------------------------------------------------------- requests
    def submit(self, query: BGP, client: int = 0,
               deadline: float | None = None) -> int:
        """Enqueue ``query``; ``deadline`` is an absolute
        ``time.perf_counter()`` instant after which the request may be
        expired at the next unit-step boundary (``None`` = never)."""
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(Request(rid, client, query, deadline))
        if deadline is not None:
            self._deadlines[rid] = deadline
        self.metrics.requests += 1
        if obs.enabled:
            self._t_submit[rid] = time.perf_counter()
        return rid

    def snapshot(self) -> dict:
        """Plain-dict snapshot of this scheduler's registry (sched.* +
        cache.* / planner.* of self-constructed components)."""
        return self.registry.snapshot()

    def run_queries(self, queries: Iterable[BGP], client: int = 0
                    ) -> tuple[list[BindingTable], list[QueryStats]]:
        """Serve ``queries`` and return (tables, stats) in input order."""
        rids = [self.submit(q, client) for q in queries]
        results = self.drain()
        tables = [results[r][0] for r in rids]
        stats = [results[r][1] for r in rids]
        return tables, stats

    def serve(self, stream: Iterable[tuple[int, BGP]]
              ) -> list[tuple[BindingTable, QueryStats]]:
        """Serve an interleaved (client, query) arrival stream in order."""
        rids = [self.submit(q, client=c) for c, q in stream]
        results = self.drain()
        return [results[r] for r in rids]

    # ---------------------------------------------------------------- ingest
    def submit_write(self, insert=None, delete=None) -> None:
        """Queue a write batch (``TripleStore.apply_delta`` arguments).

        Queued writes apply at the next **wave boundary**: the entry of
        the next ``drain``, or between waves of a drain in progress.
        In-flight jobs keep serving the epoch view they started on
        (``_EpochView`` pinning), fresh waves pick up the post-write
        epoch.
        """
        self._writes.append((insert, delete))

    def ingest(self, insert=None, delete=None) -> int:
        """Apply a write batch now (outside a drain) or queue it for the
        next wave boundary (inside one); returns the store epoch visible
        to the caller after the call."""
        self.submit_write(insert=insert, delete=delete)
        if not self._draining:
            self._apply_writes()
        return self.store.epoch

    def _apply_writes(self) -> bool:
        """Drain the write queue into the store's delta overlay; refresh
        the epoch-derived statics when the epoch moved.  Returns whether
        anything was applied."""
        if not self._writes:
            return False
        writes, self._writes = self._writes, []
        for ins, dele in writes:
            self.store.apply_delta(insert=ins, delete=dele)
        self._refresh_epoch()
        return True

    def _refresh_epoch(self) -> None:
        """Re-derive everything keyed off the store epoch: the cost-model
        statics (the *logical* triple count moved), the plan memo (plan
        ordering follows merged cardinalities, so post-write queries must
        re-plan to stay byte-identical with a rebuilt store), and the
        cache/planner sweeps (with changed-predicate carry-over)."""
        if self.store.epoch == self._cost_epoch:
            return
        n = self.store.n_triples
        self._logn = log_factor(n)
        self._probe_ops = kops.probe_op_cost(n)
        self._cost_epoch = self.store.epoch
        self._plan_memo.clear()
        self._sync_components()

    def _sync_components(self) -> None:
        """Sweep the (possibly shared) cache and planner up to the current
        epoch, handing each the predicate set changed since *its* last
        sweep so untouched entries carry over instead of dropping
        (``None`` — unknown history — degrades to the full sweep)."""
        ep = self.store.epoch
        for comp in (self.cache, self.planner):
            if comp.synced_epoch != ep:
                changed = self.store.changed_preds_since(comp.synced_epoch)
                comp.sync_epoch(ep, changed_preds=changed)

    def _plan(self, query: BGP) -> QueryPlan:
        plan = self._plan_memo.get(query)
        if plan is None:
            plan = plan_query(self.store, query, self.cfg)
            self._plan_memo[query] = plan
        return plan

    def _start_cap(self, plan: QueryPlan, jkey: tuple) -> int:
        if not self.scfg.cap_hints:
            return self.cfg.cap
        if self.cfg.capacity_planner:
            return self.planner.query_cap(plan)
        return self._cap_hints.get(jkey, self.cfg.cap)

    # ---------------------------------------------------------------- drain
    def drain(self) -> dict[int, tuple[BindingTable | None, QueryStats]]:
        """Execute all pending requests; returns {rid: (table, stats)}.

        A request expired at a unit-step boundary (its absolute deadline
        passed) maps to ``(None, stats)`` — the stats accumulated up to
        the boundary — and counts in ``metrics.deadline_expired``; the
        rest of its wave is unaffected.

        Pending requests are popped at entry, so an exception mid-drain
        loses them: a caller that retries submits them again.
        """
        requests, self._pending = self._pending, []
        results: dict[int, tuple[BindingTable | None, QueryStats]] = {}

        # wave boundary zero: queued writes land before any wave starts
        self._draining = True
        self._apply_writes()

        # store mutated since the cache/planner last swept: reconcile
        # fragments and high-water marks now (keys are epoch-tagged, so
        # they could never alias — this reclaims touched entries' memory
        # eagerly and carries untouched-predicate entries into the new
        # epoch; the sweep state lives on the shared objects so fresh
        # schedulers still trigger it)
        self._sync_components()

        # bucket by (signature, cap, resume unit); collapse identical
        # in-flight queries
        buckets: OrderedDict[tuple, list[_Job]] = OrderedDict()
        job_of: dict[tuple, _Job] = {}
        for req in requests:
            plan = self._plan(req.query)
            jkey = (plan.signature, plan.consts)
            job = job_of.get(jkey) if self.scfg.collapse_duplicates else None
            if job is None:
                cap = self._start_cap(plan, jkey)
                job = _Job(plan, plan.consts, cap, [req.rid])
                job_of[jkey] = job
                buckets.setdefault((plan.signature, job.cap, 0, None),
                                   []).append(job)
                self.metrics.jobs += 1
            else:
                job.rids.append(req.rid)

        try:
            while buckets:
                (sig, cap, k0, _vep), jobs = buckets.popitem(last=False)
                lanes = self.scfg.lanes
                for i in range(0, len(jobs), lanes):
                    wave = jobs[i:i + lanes]
                    retries = self._run_wave(wave, results)
                    for job in retries:
                        # the pinned view epoch keys the bucket so retries
                        # from different epochs never share one wave
                        vep = job.view.epoch if job.view is not None else None
                        buckets.setdefault((sig, job.cap, job.resume_k, vep),
                                           []).append(job)
                    # wave boundary: writes queued while serving land
                    # here — the wave that just finished served its
                    # pinned view, the next wave (and its retries, via
                    # the pins) stays torn-free
                    self._apply_writes()
        finally:
            self._draining = False
        self._t_submit.clear()  # unconditional: no leak across obs toggles
        self._deadlines.clear()
        return results

    # ------------------------------------------------------------ deadlines
    def _job_deadline(self, job: _Job) -> float | None:
        """A collapsed job's effective deadline: the latest of its rids'
        deadlines, or ``None`` (never expire) if any rid has none — a
        no-deadline requester is owed a full result, so a duplicate with
        a deadline can never expire the shared execution under it."""
        dl = None
        for rid in job.rids:
            d = self._deadlines.get(rid)
            if d is None:
                return None
            dl = d if dl is None else max(dl, d)
        return dl

    def _expire(self, job: _Job, a: _LaneAcc, ovf_flag: bool,
                results: dict) -> None:
        """Deliver a deadline expiry: ``(None, stats-so-far)`` per rid."""
        self.metrics.deadline_expired += len(job.rids)
        stats = QueryStats(
            nrs=a.nrs, ntb=a.ntb, server_ops=a.server, client_ops=a.client,
            n_results=0, overflow=ovf_flag,
            cache_hits=a.hits, cache_misses=a.misses,
            nrs_saved=a.nrs_saved, ntb_saved=a.ntb_saved,
        )
        t1 = time.perf_counter() if obs.enabled else 0.0
        for rid in job.rids:
            results[rid] = (None, stats)
            self._deadlines.pop(rid, None)
            t0 = self._t_submit.pop(rid, None)
            if obs.enabled and t0 is not None:
                self.registry.observe("sched.query_latency_s", t1 - t0)

    # ----------------------------------------------------------------- wave
    def _run_wave(self, jobs: list[_Job],
                  results: dict[int, tuple[BindingTable, QueryStats]]
                  ) -> list[_Job]:
        """Run one padded wave of same-signature, same-cap, same-resume-unit
        jobs through the per-unit stepped batch path.  Completed jobs land
        in ``results``; overflowed ones come back as resumable 4x-cap retry
        jobs seeded at the failing unit.

        Wave state lives on the device between steps: the cache phase
        ships 16-byte digests per lane, cache hits replay on the device
        (uploaded deltas), and Omega blocks cross to the host only for a
        miss's recorded prefix or an overflow-retire's checkpoint
        (counted in ``metrics.host_block_pulls``) — and once at finalize
        to deliver the responses.
        """
        scfg = self.scfg
        device = self.device
        plan, cap = jobs[0].plan, jobs[0].cap
        k0 = jobs[0].resume_k
        n_active = len(jobs)
        B = 1  # smallest power-of-two width that fits, capped at scfg.lanes
        while B < min(n_active, scfg.lanes):
            B *= 2
        # --- epoch view: pinned by retries, current for fresh jobs --------
        # (jobs in one wave share the view by bucket construction: fresh
        # buckets are all-None, retry buckets are keyed by the view epoch)
        view = next((j.view for j in jobs if j.view is not None), None)
        V = max(plan.n_vars, 1)
        if view is None:
            view = _EpochView(self.store.epoch,
                              self.store.device_arrays(device),
                              self._logn, self._probe_ops)
        for job in jobs:
            job.view = view
        epoch = view.epoch
        dev = view.dev

        consts = np.zeros((B, max(len(plan.consts), 1)), np.int64)
        for j, job in enumerate(jobs):
            consts[j, :len(job.consts)] = job.consts
        consts_dev = torch.from_numpy(
            np.ascontiguousarray(consts[:, :len(plan.consts)])).to(device)

        rows_h = np.full((B, cap, V), -1, np.int32)
        valid_h = np.zeros((B, cap), bool)
        counts = [0] * B
        for j, job in enumerate(jobs):
            if job.seed is None:
                valid_h[j, 0] = True  # fresh job: the all-unbound seed row
                counts[j] = 1
            else:  # resume: the checkpointed valid prefix
                m = job.seed.shape[0]
                rows_h[j, :m] = job.seed
                valid_h[j, :m] = True
                counts[j] = m
        ovf = np.zeros((B,), bool)
        acc = [job.acc if job.acc is not None else _LaneAcc()
               for job in jobs]
        self.metrics.waves += 1

        # wave state is device-resident for the whole wave; host numpy
        # exists only in the seeds above and the finalize pull below
        rows_d = torch.from_numpy(rows_h).to(device)
        valid_d = torch.from_numpy(valid_h).to(device)

        retired: set[int] = set()
        retries: list[_Job] = []

        def _retire(j: int, k: int) -> None:
            job = jobs[j]
            # the checkpointed seed: this lane's pre-step valid prefix
            # (rows_d still holds the unit's input state at both call
            # sites) — one counted Omega-block pull
            seed = rows_d[j, :n_in[j]].cpu().numpy()
            self.metrics.host_block_pulls += 1
            retries.append(_Job(job.plan, job.consts,
                                min(cap * 4, self.cfg.max_cap), job.rids,
                                resume_k=k, seed=seed, acc=acc[j],
                                peak_seen=job.peak_seen))
            retired.add(j)
            self.metrics.retries += 1

        for k in range(k0, len(plan.units)):
            up = plan.units[k]
            io = unit_io(up)
            active = [j for j in range(n_active) if j not in retired]
            # cooperative deadline check: a job whose every rid has an
            # expired absolute deadline is answered (None, stats-so-far)
            # here, at the unit boundary, instead of burning the rest of
            # the wave (the remaining lanes step on without it)
            if active and self._deadlines:
                now = time.perf_counter()
                for j in list(active):
                    dl = self._job_deadline(jobs[j])
                    if dl is not None and now >= dl:
                        self._expire(jobs[j], acc[j], bool(ovf[j]), results)
                        retired.add(j)
                        active.remove(j)
            if not active:
                break
            n_in = {j: counts[j] for j in active}

            # --- cache phase: digest-first canonicalization ---------------
            status: dict[int, tuple[str, object]] = {}
            keys: dict[int, tuple] = {}
            if scfg.use_cache:
                d = stepper.digest_step(rows_d, valid_d,
                                        io.read_cols).tolist()
                first_of: dict[tuple, int] = {}
                for j in active:
                    cvals = tuple(int(consts[j, i]) for i in io.const_idx)
                    key = unit_digest_key(io, cvals, cap, epoch, n_in[j],
                                          d[j])
                    keys[j] = key
                    if key in first_of:
                        status[j] = ("shared", first_of[key])
                        self.cache.note_shared_hit()
                        continue
                    entry = self.cache.get(key, epoch)
                    if entry is None:
                        first_of[key] = j
                        status[j] = ("miss", None)
                    else:
                        status[j] = ("hit", entry)
            else:
                status = {j: ("miss", None) for j in active}

            need_step = any(s == "miss" for s, _ in status.values())
            ops_lane: dict[int, int] = {}
            if need_step:
                step = stepper.unit_step(up, self.store.radix,
                                         logn=view.logn)
                r_o, v_o, o_o, src_o, ops_o, cnt_o, peak_o = step(
                    dev, consts_dev, rows_d, valid_d,
                    torch.from_numpy(ovf).to(device), active)
                # one host read for the wave's per-lane scalars
                ops_np, cnt_np, ovf_np, peak_np = torch.stack(
                    [ops_o, cnt_o, o_o.to(torch.int64), peak_o]
                ).cpu().numpy()
                ovf_np = ovf_np.astype(bool)
                self.metrics.steps += 1
                self.metrics.lane_steps += B
                self.metrics.active_lane_steps += len(active)
                for j in active:
                    ops_lane[j] = int(ops_np[j])
                    if bool(ovf_np[j]) and not bool(ovf[j]) \
                            and cap < self.cfg.max_cap:
                        # resumable overflow: checkpoint this unit's input
                        # prefix (still the pre-step device state) and
                        # requeue at 4x — units 0..k-1 are never re-run
                        _retire(j, k)
                        continue
                    if status[j][0] == "miss" and scfg.use_cache \
                            and not bool(ovf[j]) \
                            and epoch == self.store.epoch:
                        # (a stale-pinned retry wave skips insertion: its
                        # fragments describe a superseded epoch and would
                        # only park dead weight under an old-epoch key)
                        # miss that needs insertion: pull only this lane's
                        # output prefix to record the replayable delta
                        self.metrics.host_block_pulls += 1
                        n_out = int(cnt_np[j])
                        out_rows = r_o[j, :n_out].cpu().numpy()
                        entry = FragmentEntry(
                            src_row=np.ascontiguousarray(
                                src_o[j, :n_out].cpu().numpy()),
                            written=np.ascontiguousarray(
                                out_rows[:, list(io.write_cols)]),
                            overflow=bool(ovf_np[j]),
                            ops=int(ops_np[j]),
                            epoch=epoch,
                            peak=int(peak_np[j]),
                        )
                        self.cache.put(keys[j], entry, epoch)
                rows_d, valid_d = r_o, v_o
                ovf = np.array(ovf_np)
                for j in active:
                    if j not in retired:
                        counts[j] = int(cnt_np[j])
                        jobs[j].peak_seen = max(jobs[j].peak_seen,
                                                int(peak_np[j]), n_in[j])
            else:
                # every active lane hit: replay the cached deltas on the
                # device (kops.replay_delta, one launch per wave).  The
                # uploaded delta is the small object — the lanes' Omega
                # blocks never cross to the host, so an all-hit wave adds
                # zero host_block_pulls (the invariant the tests pin).
                self.metrics.steps_skipped += 1
                live: dict[int, FragmentEntry] = {}
                for j in active:
                    entry = status[j][1]
                    if isinstance(entry, int):  # shared alias of a hit lane
                        entry = status[entry][1]
                    if entry.overflow and not bool(ovf[j]) \
                            and cap < self.cfg.max_cap:
                        # the cached unit overflowed at this cap: resume
                        # from the checkpointed seed like a computed one
                        _retire(j, k)
                        continue
                    live[j] = entry
                if not live:  # every hit lane retired on a cached overflow
                    continue
                n_w = len(io.write_cols)
                m = 1
                for e in live.values():
                    m = max(m, e.n_out)
                # pow2-pad the delta width, as the reference does
                m = min(1 << (m - 1).bit_length(), cap)
                src_h = np.zeros((B, m), np.int32)
                wr_h = np.zeros((B, m, n_w), np.int32)
                nout_h = np.zeros((B,), np.int32)  # non-hit lanes: empty
                for j, e in live.items():
                    if e.n_out:
                        src_h[j, :e.n_out] = e.src_row
                        if n_w:
                            wr_h[j, :e.n_out] = e.written
                    nout_h[j] = e.n_out
                rows_d, valid_d = kops.replay_delta(
                    rows_d, torch.from_numpy(src_h).to(device),
                    torch.from_numpy(wr_h).to(device),
                    torch.from_numpy(nout_h).to(device), io.write_cols)
                for j, e in live.items():
                    ovf[j] = bool(ovf[j]) | e.overflow
                    counts[j] = e.n_out
                    ops_lane[j] = e.ops
                    jobs[j].peak_seen = max(jobs[j].peak_seen, e.peak,
                                            n_in[j])

            # --- host stats accounting (twin of engine._execute) ----------
            for j in active:
                if j in retired:
                    continue
                nrs_d, ntb_d, server_d, client_d = stepper.unit_cost(
                    self.cfg, k, up, n_in[j], counts[j], ops_lane[j],
                    view.probe_ops)
                a = acc[j]
                a.nrs += nrs_d
                a.ntb += ntb_d
                a.server += server_d
                a.client += client_d
                if status[j][0] == "miss":
                    a.misses += 1
                else:
                    a.hits += 1
                    a.nrs_saved += nrs_d
                    a.ntb_saved += ntb_d

        # --------------------------------------------------------- finalize
        # the one end-of-wave materialisation: delivering the responses
        # (deliberately not counted in host_block_pulls, which tracks
        # unit-stepping traffic)
        rows_h = rows_d.cpu().numpy()
        valid_h = valid_d.cpu().numpy()
        for j, job in enumerate(jobs):
            if j in retired:
                continue
            if self.scfg.cap_hints:
                if self.cfg.capacity_planner:
                    # record the query's true need (largest per-unit peak),
                    # not the cap it ran at — warm resubmissions then get
                    # right-sized tables even where the oracle overshot
                    self.planner.observe_query(
                        job.plan, self.cfg.max_cap if bool(ovf[j])
                        else self.planner.snug(job.peak_seen))
                elif job.cap != self.cfg.cap:
                    self._cap_hints[(job.plan.signature, job.consts)] = job.cap
            a = acc[j]
            n_results = counts[j]
            nrs, ntb = a.nrs, a.ntb
            if self.cfg.interface == "endpoint":
                nrs, ntb = stepper.endpoint_totals(self.cfg, n_results,
                                                   plan.n_vars)
                if plan.units and a.hits == len(plan.units):
                    # whole query served from cache: the one endpoint
                    # request never reaches the server
                    a.nrs_saved, a.ntb_saved = nrs, ntb
                else:
                    a.nrs_saved = a.ntb_saved = 0
            table = BindingTable(torch.from_numpy(rows_h[j].copy()),
                                 torch.from_numpy(valid_h[j].copy()),
                                 torch.tensor(bool(ovf[j])))
            stats = QueryStats(
                nrs=nrs, ntb=ntb, server_ops=a.server, client_ops=a.client,
                n_results=n_results, overflow=bool(ovf[j]),
                cache_hits=a.hits, cache_misses=a.misses,
                nrs_saved=a.nrs_saved, ntb_saved=a.ntb_saved,
            )
            results[job.rids[0]] = (table, stats)
            t1 = time.perf_counter() if obs.enabled else 0.0
            for rid in job.rids:
                # reap unconditionally: entries recorded while obs was on
                # must not leak if it is toggled off before the drain
                self._deadlines.pop(rid, None)
                t0 = self._t_submit.pop(rid, None)
                if obs.enabled and t0 is not None:
                    self.registry.observe("sched.query_latency_s", t1 - t0)
            if len(job.rids) > 1:
                # collapsed duplicates: whole response fanned out from the
                # shared execution — every unit request cache-served
                n_units = len(plan.units)
                self.cache.note_shared_hit(n_units * (len(job.rids) - 1))
                dup = stats._replace(cache_hits=n_units, cache_misses=0,
                                     nrs_saved=nrs, ntb_saved=ntb)
                for rid in job.rids[1:]:
                    results[rid] = (table, dup)
        return retries
