"""Degree-based capacity planning: size binding tables from the data.

Capacity overflow is this system's timeout analogue.  Instead of a blind
geometric ladder (restart the whole query at 4x table capacity until it
fits), this module sizes tables from the store.  Two sources, in priority
order:

1. **High-water-mark memory** — an epoch-tagged map from
   ``(plan signature, constants, unit, epoch)`` to the capacity a unit
   last *succeeded* at.  The store epoch is folded into the key, so
   observations made against other contents never alias; ``sync_epoch``
   sweeps them.  Warm runs jump straight to the observed
   capacity.
2. **Degree oracle** — for cold plans, an upper bound on each unit's
   result rows from per-predicate degree statistics: the max subject
   out-degree and max object in-degree per predicate, derived from the
   store's sorted base key columns via
   ``kops.max_run_length_per_segment`` (two reductions on the planner's
   device, once per *base* epoch), plus the insert runs' maxima
   (``TripleStore.max_ins_degrees``, delta-sized, once per epoch) under
   a delta overlay.  Chained through the plan's branch cases it bounds
   every intermediate table, so an oracle-sized run cannot overflow
   unless the bound exceeds ``max_cap``.

Byte-identity needs no ladder alignment: a non-overflowing evaluation's
valid rows and cost account are independent of the capacity it ran at, so
*any* capacity covering a unit's true peak gives the blind ladder's
results.  Planned capacities are therefore **snug**; only in-run overflow
*growth* keeps the 4x factor (``rung``).

One planner may serve any number of engines and schedulers: it is
host-side state consulted between device steps.  On a new store epoch
``sync_epoch`` sweeps the marks of other epochs, or, given the
predicates the delta touched (the scheduler passes
``TripleStore.changed_preds_since``), carries the untouched ones over.
The sharded-step hints of the JAX reference's planner are not part of
this package yet.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.obs.registry import RegistryView
from repro_torch.rdf.store import TripleStore, resolve_device

if TYPE_CHECKING:  # EngineConfig lives in engine.py; engine imports us
    from repro_torch.core.engine import EngineConfig, QueryPlan


# branch cases whose output row count can exceed their input row count,
# mapped to the degree statistic that bounds the per-row expansion factor
_EXPANDING = {"probe_ovar_free": "ps",  # objects within each (p, s) run
              "scan_ovar_bound": "po",  # subjects within each (p, o) run
              "scan_ovar_free": "pred"}  # the whole predicate run


class PlannerStats(RegistryView):
    """Planner tallies as ``planner.*`` registry instruments."""

    _PREFIX = "planner"
    _FIELDS = (
        "oracle_caps",  # capacities served from the degree oracle
        "hwm_caps",  # capacities served from the high-water-mark memory
        "observations",
        "swept",  # HWM entries dropped on an epoch sweep
        # HWM entries re-keyed to a new epoch because the delta touched
        # none of their constants' predicates (warm carry-over; mirrors
        # cache.carryover)
        "carryover",
    )


@dataclass
class CapacityPlanner:
    """Capacity oracle + high-water-mark memory.

    ``max_entries`` bounds the HWM map (LRU); degree statistics are
    recomputed lazily — the base half per store base epoch, on ``device``
    (default ``"cuda"``; the engine passes its own), the delta half per
    store epoch on the host.
    """

    store: TripleStore
    cfg: "EngineConfig"
    max_entries: int = 65536
    device: object = None
    # shared MetricsRegistry to mount the planner.* instruments on; None =
    # private registry
    registry: object = None
    stats: PlannerStats = None
    _hwm: OrderedDict = field(default_factory=OrderedDict, repr=False)
    _deg_epoch: int = field(default=-1, repr=False)
    _deg_base_epoch: int = field(default=-1, repr=False)
    _base_ps: np.ndarray | None = field(default=None, repr=False)
    _base_po: np.ndarray | None = field(default=None, repr=False)
    _max_ps: np.ndarray | None = field(default=None, repr=False)
    _max_po: np.ndarray | None = field(default=None, repr=False)
    _swept_epoch: int = field(default=0, repr=False)

    def __post_init__(self):
        if self.stats is None:
            self.stats = PlannerStats(self.registry)

    # -------------------------------------------------------------- sizing
    def rung(self, need: int) -> int:
        """Smallest blind-ladder rung ``cfg.cap * 4**j`` covering ``need``
        (capped at ``max_cap``)."""
        cap = self.cfg.cap
        while cap < need and cap < self.cfg.max_cap:
            cap *= 4
        return min(cap, self.cfg.max_cap)

    # capacities below this buy nothing (table ops are overhead-dominated)
    MIN_QUANTUM = 1024

    def snug(self, need: int) -> int:
        """Smallest snug capacity covering ``need`` (capped at ``max_cap``)
        — what oracle bounds and high-water marks are quantized to: 1/16
        of the need's power-of-two octave, floored at
        ``max(cfg.cap, MIN_QUANTUM)``."""
        need = max(int(need), 1)
        if need >= self.cfg.max_cap:
            return self.cfg.max_cap
        q = max(self.cfg.cap, self.MIN_QUANTUM,
                1 << max((need - 1).bit_length() - 4, 0))
        return min(-(-need // q) * q, self.cfg.max_cap)

    # ------------------------------------------------------- degree oracle
    def _degree_stats(self) -> tuple[np.ndarray, np.ndarray]:
        """(max subject out-degree, max object in-degree) per predicate.

        The base half is two ``kops`` segment reductions over the base
        key columns on the planner's device, cached per **base** epoch: a
        delta epoch never re-reads the full store.  Under a delta overlay
        a merged run is at most base max + insert max long (the two
        interleave, tombstones only shrink runs), so the per-epoch half
        adds the insert runs' per-predicate maxima
        (``TripleStore.max_ins_degrees``, delta-sized host work).
        """
        s = self.store
        if self._deg_base_epoch != s.base_epoch or self._base_ps is None:
            dev = s.device_arrays(resolve_device(self.device))
            n_seg = s.n_predicates + 1
            stats = []
            for keys in (dev.key_ps_pso, dev.key_po_pos):
                seg = torch.div(keys, s.radix, rounding_mode="floor")
                stats.append(kops.max_run_length_per_segment(
                    keys, seg, n_seg).cpu().numpy())
            self._base_ps, self._base_po = stats
            self._deg_base_epoch = s.base_epoch
            self._deg_epoch = -1  # the delta half follows the new base
        if self._deg_epoch != s.epoch or self._max_ps is None:
            ins_ps, ins_po = s.max_ins_degrees()
            self._max_ps = self._base_ps + ins_ps
            self._max_po = self._base_po + ins_po
            self._deg_epoch = s.epoch
        return self._max_ps, self._max_po

    def _branch_factor(self, consts: tuple[int, ...], branch) -> int:
        """Upper bound on the per-input-row output multiplier of a branch."""
        kind = _EXPANDING.get(branch.case)
        if kind is None:
            if branch.case == "scan_oconst":
                # the whole (p, o) run expands under every input row;
                # both terms are constants, so the bound is exact
                p = consts[branch.pred_ci]
                o = consts[branch.obj_src[1]]
                return self.store.tp_cardinality(int(p), o=int(o))
            return 1  # probe_oconst / probe_ovar_bound: pure filters
        p = int(consts[branch.pred_ci])
        if kind == "pred":
            # merged-exact predicate cardinality: the base run alone is
            # no upper bound once the delta holds inserts
            return self.store.tp_cardinality(p)
        max_ps, max_po = self._degree_stats()
        table = max_ps if kind == "ps" else max_po
        return int(table[p]) if p < table.shape[0] else 0

    def unit_bounds(self, plan: "QueryPlan") -> list[int]:
        """Chained per-unit upper bounds on binding-table rows: expansion
        factors multiply, filters keep the bound, clamped at ``max_cap``."""
        bound = 1
        out: list[int] = []
        for up in plan.units:
            for b in up.branches:
                bound = min(bound * self._branch_factor(plan.consts, b),
                            self.cfg.max_cap)
            out.append(bound)
        return out

    # --------------------------------------------------- capacity requests
    def unit_caps(self, plan: "QueryPlan") -> list[int]:
        """Per-unit starting capacities: snug HWM if observed at the
        current epoch, else the oracle bound's snug capacity."""
        epoch = self.store.epoch
        caps = []
        bounds = None
        for k in range(len(plan.units)):
            hwm = self._get_hwm((plan.signature, plan.consts, k, epoch))
            if hwm is not None:
                self.stats.hwm_caps += 1
                caps.append(hwm)
            else:
                if bounds is None:
                    bounds = self.unit_bounds(plan)
                self.stats.oracle_caps += 1
                caps.append(self.snug(bounds[k]))
        return caps

    def seeded_unit_bound(self, plan: "QueryPlan", k: int, n_in: int) -> int:
        """Upper bound on unit ``k``'s branch-boundary row counts given an
        *observed* seed of ``n_in`` rows: the chain restarted from the
        seed prefix, so a table at this capacity cannot overflow."""
        run = m = max(int(n_in), 1)
        for b in plan.units[k].branches:
            run = min(run * self._branch_factor(plan.consts, b),
                      self.cfg.max_cap)
            m = max(m, run)
        return m

    def unit_start_cap(self, plan: "QueryPlan", k: int, n_in: int) -> int:
        """Starting capacity for unit ``k`` seeded with ``n_in`` rows:
        the snug HWM if one is recorded at the current epoch, else the
        snug capacity of the *seeded* oracle bound (so capacities shrink
        back after a fat intermediate collapses)."""
        epoch = self.store.epoch
        hwm = self._get_hwm((plan.signature, plan.consts, k, epoch))
        if hwm is not None:
            self.stats.hwm_caps += 1
            return max(hwm, self.snug(n_in))
        self.stats.oracle_caps += 1
        return self.snug(self.seeded_unit_bound(plan, k, n_in))

    def query_cap(self, plan: "QueryPlan") -> int:
        """Whole-query starting capacity (the scheduler's per-wave tables
        share one capacity across units): HWM if observed, else the snug
        capacity covering the largest per-unit bound."""
        epoch = self.store.epoch
        hwm = self._get_hwm((plan.signature, plan.consts, "q", epoch))
        if hwm is not None:
            self.stats.hwm_caps += 1
            return hwm
        self.stats.oracle_caps += 1
        bounds = self.unit_bounds(plan)
        return self.snug(max(bounds, default=1))

    # --------------------------------------------------------- observation
    def _get_hwm(self, key: tuple) -> int | None:
        cap = self._hwm.get(key)
        if cap is not None:
            self._hwm.move_to_end(key)
        return cap

    def _put_hwm(self, key: tuple, cap: int) -> None:
        self._hwm[key] = cap
        self._hwm.move_to_end(key)
        self.stats.observations += 1
        while len(self._hwm) > self.max_entries:
            self._hwm.popitem(last=False)

    def observe_unit(self, plan: "QueryPlan", k: int, cap: int) -> None:
        """Record that unit ``k`` of ``plan`` succeeded at ``cap``."""
        self._put_hwm((plan.signature, plan.consts, k, self.store.epoch), cap)

    def observe_query(self, plan: "QueryPlan", cap: int) -> None:
        """Record a whole query's final (non-overflow or latched) cap."""
        self._put_hwm((plan.signature, plan.consts, "q", self.store.epoch),
                      cap)

    # --------------------------------------------------------------- epoch
    @property
    def synced_epoch(self) -> int:
        """The store epoch this planner last swept against (callers pair
        it with ``TripleStore.changed_preds_since`` for carry-over)."""
        return self._swept_epoch

    def sync_epoch(self, epoch: int, changed_preds=None) -> int:
        """Sweep HWM entries from other epochs on first sight of a new one
        (the epoch is also folded into every key, so this only reclaims
        memory).  Returns the number dropped.

        With ``changed_preds`` (the predicate ids touched since the last
        sweep) an entry whose constants (``key[1]`` — every predicate its
        plan probes is among them) avoid the changed set is re-keyed to
        the new epoch instead of dropped, so untouched plans keep their
        warm capacities across delta epochs.  A high-water mark is an
        upper bound on the untouched plan's need, so carrying it is
        byte-safe (capacity-independence).  ``None`` sweeps everything,
        as the serial engine's call does."""
        if epoch == self._swept_epoch:
            return 0
        self._swept_epoch = epoch
        if changed_preds is not None:
            changed = frozenset(changed_preds)
            hwm = OrderedDict()
            dropped = 0
            for k, cap in self._hwm.items():
                if k[3] == epoch:
                    hwm[k] = cap
                elif changed.isdisjoint(k[1]):
                    hwm[k[:3] + (epoch,)] = cap
                    self.stats.carryover += 1
                else:
                    dropped += 1
            self._hwm = hwm
            self.stats.swept += dropped
            return dropped
        stale = [k for k in self._hwm if k[3] != epoch]
        for k in stale:
            del self._hwm[k]
        self.stats.swept += len(stale)
        return len(stale)
