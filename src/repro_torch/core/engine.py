"""The four RDF interfaces as query engines: SPF, brTPF, TPF, endpoint.

All four share one seeded left-deep evaluator (``server.eval_unit``); they
differ in (a) unit granularity — star patterns for SPF/endpoint, single
triple patterns for TPF/brTPF — and (b) the interface cost model:

                 unit        Omega block   where joins run    NRS per unit
    TPF          triple      1             client             |Omega| (+pages)
    brTPF        triple      30            server (bind)      ceil(|Omega|/30)
    SPF          star        30            server (star+bind) ceil(|Omega|/30)
    endpoint     star        unbounded     server             1 per query

Join order across units: most selective (lowest Def. 6 cardinality
estimate) first, greedily constrained to units sharing a variable with the
already-bound set (no accidental cartesian products) — the client strategy
of Section 5.1.  NRS/NTB are computed *exactly* from result counts.

Execution model
---------------
A query (``run``) runs on the engine's device — the card unless the
caller passes ``device="cpu"`` — eagerly, unit by unit.  Table capacities
come from the capacity planner (``core/capacity.py``): each unit starts at
a data-informed *snug* capacity (the unit's high-water mark at the
current store epoch, or the degree oracle's bound seeded from the
observed input prefix).  Capacity overflow (the timeout analogue) is
handled *resumably*: the last valid binding table is the checkpoint, and
only the overflowed unit's table regrows at 4x.  At ``max_cap`` the
overflow flag latches and evaluation continues on the truncated table,
exactly like the blind ladder's give-up rung.  When the planner proves
the base capacity cannot overflow, the whole query runs in one pass
(``_run_blind``) with no per-unit host reads.

Because a non-overflowing evaluation's valid rows and cost account are
independent of the capacity it ran at, the planned path is byte-identical
(rows and gross ``QueryStats``) to the blind ladder — restart the whole
query at 4x capacity until it fits — which ``EngineConfig(
capacity_planner=False)`` selects.  Both are byte-identical to the JAX
reference's ``QueryEngine.run`` on the same store and queries.

Live store: each run reads the store's device view afresh, so a query
runs on the epoch current at its start, and ``logn`` / ``probe_ops``
derive from ``n_triples``, the *logical* count under a delta overlay,
which keeps the account equal to a rebuilt store's.

Cost accounting: the TPF page path charges fragment location at
``kops.probe_op_cost`` (``2 * ceil(log2 n)`` bisection steps, the same on
every device).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, replace
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import stepper
from repro_torch.core.bindings import BindingTable, unit_table
from repro_torch.core.capacity import CapacityPlanner
from repro_torch.core.patterns import BGP, StarPattern, star_decomposition
from repro_torch.core.server import UnitPlan, eval_unit, log_factor, plan_unit
from repro_torch.kernels import ops as kops
from repro_torch.rdf.store import StoreArrays, TripleStore, resolve_device


INTERFACES = ("tpf", "brtpf", "spf", "endpoint")


@dataclass(frozen=True)
class EngineConfig:
    interface: str = "spf"
    page_size: int = 50  # LDF page size (paper: 50)
    omega: int = 30  # max bindings per request (paper: 30)
    cap: int = 4096  # binding-table capacity (the timeout analogue)
    max_cap: int = 1 << 20  # overflow retry ceiling (4x growth); then give up
    # size capacities from the data (degree oracle + high-water marks,
    # core/capacity.py) and resume overflow at the failing unit; False
    # restores the blind whole-query 4x retry ladder (byte-identical)
    capacity_planner: bool = True
    # wire-format constants for NTB (bytes): pattern/bindings serialisation
    request_base_bytes: int = 300  # HTTP request overhead
    page_header_bytes: int = 200  # per-page metadata/controls (Def. 4 M', C')
    term_bytes: int = 4  # dictionary-encoded term on the wire


class QueryStats(NamedTuple):
    """Per-query cost account (int64 device scalars or host ints).

    ``nrs``/``ntb`` are *gross* counts — what the interface protocol costs
    with no cache in front of the server.  The cache fields stay zero on
    the serial ``run`` path (the scheduler that fills them is not part of
    this package yet).
    """

    nrs: torch.Tensor  # number of requests to the server
    ntb: torch.Tensor  # transferred bytes, both directions
    server_ops: torch.Tensor  # server-side work units
    client_ops: torch.Tensor  # client-side work units
    n_results: torch.Tensor
    overflow: torch.Tensor  # bool
    cache_hits: torch.Tensor = 0  # unit requests served from the cache
    cache_misses: torch.Tensor = 0  # unit requests that hit the store
    nrs_saved: torch.Tensor = 0  # requests the cache kept off the origin
    ntb_saved: torch.Tensor = 0  # bytes the cache kept off the origin


@dataclass(frozen=True)
class QueryPlan:
    units: tuple[UnitPlan, ...]
    n_vars: int
    consts: tuple[int, ...]
    interface: str

    @property
    def signature(self) -> tuple:
        return (self.interface, self.n_vars,
                tuple(u.signature for u in self.units))


# --------------------------------------------------------------------------
# planning
# --------------------------------------------------------------------------

def _units_for_interface(bgp: BGP, interface: str) -> list[StarPattern]:
    stars = star_decomposition(bgp)
    if interface in ("spf", "endpoint"):
        return stars
    # TPF/brTPF: one unit per triple pattern
    units: list[StarPattern] = []
    for star in stars:
        for p, o in star.branches:
            units.append(StarPattern(star.subject, ((p, o),)))
    return units


def plan_query(store: TripleStore, bgp: BGP, cfg: EngineConfig) -> QueryPlan:
    """Greedy selective-first join ordering over units (Section 5.1)."""
    units = _units_for_interface(bgp, cfg.interface)

    # Estimate each unit's cardinality with an *unseeded* plan (this is what
    # the client learns from each unit's first-page metadata).
    est = []
    for u in units:
        scratch: list[int] = []
        p, _ = plan_unit(store, u, frozenset(), scratch)
        est.append(p.est_card)

    remaining = list(range(len(units)))
    bound: frozenset[int] = frozenset()
    consts: list[int] = []
    ordered: list[UnitPlan] = []
    while remaining:
        # prefer units connected to the bound set; among those, lowest card
        connected = [i for i in remaining
                     if not bound or set(units[i].variables()) & bound]
        pool = connected if connected else remaining
        nxt = min(pool, key=lambda i: est[i])
        plan, bound = plan_unit(store, units[nxt], bound, consts)
        ordered.append(plan)
        remaining.remove(nxt)
    return QueryPlan(tuple(ordered), bgp.n_vars, tuple(consts), cfg.interface)


# --------------------------------------------------------------------------
# execution + cost model
# --------------------------------------------------------------------------

def _ceil_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return (a + b - 1) // b


def _execute(plans: tuple[UnitPlan, ...], n_vars: int, cfg: EngineConfig,
             radix: int, logn: int, probe_ops: int, dev: StoreArrays,
             const_vec: torch.Tensor) -> tuple[BindingTable, QueryStats]:
    """Run every unit at ``cfg.cap`` in one pass, accounting on the device
    (no host read until the caller checks the overflow flag)."""
    device = const_vec.device
    table = unit_table(cfg.cap, max(n_vars, 1), device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    nrs = ntb = server_ops = client_ops = zero
    tb = cfg.term_bytes

    for k, up in enumerate(plans):
        in_count = table.count()
        table, ops, _ = eval_unit(dev, radix, up, const_vec, table,
                                  logn=logn)
        out_count = table.count()
        matched_triples = out_count * up.n_triple_patterns

        if cfg.interface == "endpoint":
            # all work server-side; traffic accounted once at the end
            server_ops = server_ops + ops
            continue

        # ---- request counting -------------------------------------------
        # one metadata request per unit (first page probe for join ordering)
        meta_req = 1
        if cfg.interface == "tpf":
            blocks = in_count.clamp(min=1) if k > 0 else zero + 1
        else:  # brtpf / spf: Omega-blocked requests
            blocks = _ceil_div(in_count.clamp(min=1), cfg.omega) if k > 0 \
                else zero + 1
        pages = _ceil_div(out_count.clamp(min=1), cfg.page_size)
        # page fetches beyond each block's first page are extra requests
        extra_pages = (pages - blocks).clamp(min=0)
        nrs = nrs + meta_req + blocks + extra_pages

        # ---- byte counting ----------------------------------------------
        sent = (blocks + meta_req + extra_pages) * cfg.request_base_bytes
        if cfg.interface in ("brtpf", "spf") and k > 0:
            # bindings serialised with each block
            n_bound_vars = len(
                {v for b in up.branches for src in (b.subj_src, b.obj_src)
                 if src[0] == "var" for v in [src[1]]})
            sent = sent + in_count * max(n_bound_vars, 1) * tb
        recv = (matched_triples * 3 * tb
                + (pages + meta_req) * cfg.page_header_bytes)
        ntb = ntb + sent + recv

        # ---- work split ---------------------------------------------------
        if cfg.interface == "tpf":
            # server only locates/pages each instantiated fragment; the
            # client performs the joins (merging bindings into its table)
            server_ops = server_ops + blocks * probe_ops + matched_triples
            client_ops = client_ops + ops
        else:
            server_ops = server_ops + ops
            client_ops = client_ops + out_count  # client merges results

    n_results = table.count()
    if cfg.interface == "endpoint":
        nrs = zero + 1
        ntb = (cfg.request_base_bytes + n_results * n_vars * tb
               + cfg.page_header_bytes)

    stats = QueryStats(
        nrs=nrs, ntb=ntb, server_ops=server_ops, client_ops=client_ops,
        n_results=n_results, overflow=table.overflow,
    )
    return table, stats


class QueryEngine:
    """Runs BGP queries against a TripleStore via one of the four interfaces.

    ``device`` is where the store is uploaded and the query runs: the card
    by default (raises where there is none), ``"cpu"`` on request.
    ``planner`` may be shared across engines on the same store; by
    default each engine owns one.
    """

    def __init__(self, store: TripleStore, cfg: EngineConfig,
                 planner: "CapacityPlanner | None" = None, device=None):
        if cfg.interface not in INTERFACES:
            raise ValueError(f"unknown interface {cfg.interface!r}")
        self.store = store
        self.cfg = cfg
        self.device = resolve_device(device)
        self.planner = planner if planner is not None \
            else CapacityPlanner(store, cfg, device=self.device)

    def plan(self, bgp: BGP) -> QueryPlan:
        return plan_query(self.store, bgp, self.cfg)

    def run(self, bgp: BGP) -> tuple[BindingTable, QueryStats]:
        """Run one query; capacity overflow (the timeout analogue) grows
        tables 4x up to ``max_cap``.

        With the capacity planner (the default) each unit starts at a
        data-informed capacity and overflow re-enters at the failing unit
        with only that unit's table regrown; with
        ``capacity_planner=False`` the whole query restarts at 4x until it
        fits.  Both return identical valid rows and gross stats.
        """
        if not obs.enabled:
            return self._run(bgp)
        t0 = time.perf_counter()
        table, stats = self._run(bgp)
        # the latency histogram lives in the global obs registry, which
        # the disabled path never mutates
        obs.registry.observe("engine.query_latency_s",
                             time.perf_counter() - t0)
        return table, stats

    def _run(self, bgp: BGP) -> tuple[BindingTable, QueryStats]:
        plan = self.plan(bgp)
        if not self.cfg.capacity_planner:
            return self._run_blind(plan)
        self.planner.sync_epoch(self.store.epoch)
        caps = self.planner.unit_caps(plan)
        if not caps or max(caps) <= self.cfg.cap:
            # the oracle/HWM proves the base capacity cannot overflow:
            # one whole-query pass with no per-unit host reads
            # (byte-identical either way)
            return self._run_blind(plan)
        return self._run_planned(plan)

    def _const_vec(self, plan: QueryPlan) -> torch.Tensor:
        return torch.as_tensor(np.asarray(plan.consts, dtype=np.int64)
                               ).to(self.device)

    def _run_blind(self, plan: QueryPlan) -> tuple[BindingTable, QueryStats]:
        """The blind ladder: restart the whole query at 4x capacity until
        it fits (the ladder-parity baseline).  The reference's jit cache
        keyed by (signature, cap, epoch) is a plain call here."""
        const_vec = self._const_vec(plan)
        dev = self.store.device_arrays(self.device)
        n = self.store.n_triples
        cap = self.cfg.cap
        while True:
            cfg = replace(self.cfg, cap=cap)
            table, stats = _execute(plan.units, plan.n_vars, cfg,
                                    self.store.radix, log_factor(n),
                                    kops.probe_op_cost(n), dev, const_vec)
            if not bool(stats.overflow) or cap >= self.cfg.max_cap:
                return table, stats
            cap *= 4

    def _run_planned(self, plan: QueryPlan
                     ) -> tuple[BindingTable, QueryStats]:
        """Unit-stepped execution with planner capacities + resumable
        overflow (see the module docstring's execution model).  Stats are
        host ints built through ``stepper.unit_cost``; each unit step costs
        one host read of its four scalars."""
        cfg = self.cfg
        store = self.store
        dev = store.device_arrays(self.device)
        const_vec = self._const_vec(plan)
        n_vars = max(plan.n_vars, 1)
        n = store.n_triples
        logn = log_factor(n)
        probe_ops = kops.probe_op_cost(n)

        cap = self.planner.unit_start_cap(plan, 0, 1) if plan.units \
            else cfg.cap
        seed = unit_table(cap, n_vars, device=self.device)
        rows, valid = seed.rows, seed.valid
        ovf_dev = seed.overflow
        overflow = False
        n_in = 1
        max_peak = 1
        nrs = ntb = server = client = 0
        for k, up in enumerate(plan.units):
            # once overflow latches (at max_cap) the blind ladder's give-up
            # rung runs everything at max_cap on the truncated table — do
            # exactly that for byte-identity
            want = cfg.max_cap if overflow \
                else self.planner.unit_start_cap(plan, k, n_in)
            if want != cap:
                rows, valid = stepper.reseat(rows, valid, want)
                cap = want
            step = stepper.serial_unit_step(up, store.radix, logn)
            while True:
                r_o, v_o, o_o, ops_o, cnt_o, peak_o = step(
                    dev, const_vec, rows, valid,
                    torch.tensor(overflow, device=self.device))
                # one host read for the step's four scalars
                unit_ovf, out_count, ops, peak = (int(x) for x in torch.stack(
                    [o_o.to(torch.int64), cnt_o, ops_o, peak_o]).tolist())
                unit_ovf = bool(unit_ovf)
                if unit_ovf and not overflow and cap < cfg.max_cap:
                    # resumable overflow: regrow only this unit's table,
                    # seeded with the checkpointed (pre-step) prefix
                    cap = min(cap * 4, cfg.max_cap)
                    rows, valid = stepper.reseat(rows, valid, cap)
                    continue
                break
            rows, valid, ovf_dev = r_o, v_o, o_o
            d = stepper.unit_cost(cfg, k, up, n_in, out_count, ops,
                                  probe_ops)
            nrs += d[0]
            ntb += d[1]
            server += d[2]
            client += d[3]
            if not unit_ovf:
                # record what the unit NEEDED (its true peak row count),
                # not the capacity it happened to run at
                self.planner.observe_unit(
                    plan, k, self.planner.snug(max(peak, n_in)))
                max_peak = max(max_peak, peak, n_in)
            overflow = unit_ovf
            n_in = out_count

        n_results = n_in
        if cfg.interface == "endpoint":
            nrs, ntb = stepper.endpoint_totals(cfg, n_results, plan.n_vars)
        # whole-query HWM: the snug cap covering the largest true peak, or
        # max_cap on a latched overflow
        self.planner.observe_query(
            plan, cfg.max_cap if overflow else self.planner.snug(max_peak))
        stats = QueryStats(
            nrs=nrs, ntb=ntb, server_ops=server, client_ops=client,
            n_results=n_results, overflow=overflow,
        )
        return BindingTable(rows, valid, ovf_dev), stats


def results_as_numpy(table: BindingTable) -> np.ndarray:
    """Valid rows as a numpy array (for tests / result checking)."""
    rows = table.rows.cpu().numpy()
    valid = table.valid.cpu().numpy()
    return rows[valid]
