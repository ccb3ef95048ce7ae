"""The sharded SPF runtime: the interface protocols over a subject-hash
sharded store, with the network's collectives as plain tensor code.

The paper's deployment is servers and clients over HTTP.  The reference
puts it on a device mesh: the server is the devices along mesh axis
``data``, each holding a subject-hash shard of the triple store
(``TripleStore.shard_by_subject``); each client is a query lane along
``model``; a request/response cycle is one collective exchange along
``data`` — the lane's current table Omega seeds local evaluation on every
shard, and the shard-local results are gathered back to the lane.

Because star-pattern matches share a subject and the store is
subject-hash sharded, *server-side star joins never communicate*: only
star-level results cross the network.  TPF/brTPF-granularity engines
gather after every triple pattern instead, so their exchange schedule is
strictly larger, which ``DistStats`` counts (rounds, rows and bytes).

This port runs on one card, where NCCL puts no two ranks: the shards are
an axis of the stacked store tensors (``stacked_shard_arrays``) and are
evaluated in a loop, as the lanes are, so there is no process group and
no mesh.  ``n_shards`` is the reference mesh's ``data`` extent.  The
collectives become tensor code: a ``psum`` is a sum over the shards, an
``all_gather`` a list of the shards' blocks, a ``ppermute`` the pairing
of two blocks inside the k-way merge's schedule
(``stepper.gather_merge_kway``).  Under owner masking the bound-subject
probes run the owner-masked probe kernel (``kops.eqrange_owned``).

Results are the reference's: each lane's table is byte-identical to the
serial engine's (the merge restores serial row order), ``server_ops`` is
the serial account, and every ``DistStats`` field equals the
reference's ``run_batch``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import stepper
from repro_torch.core.bindings import BindingTable, unit_table
from repro_torch.core.engine import EngineConfig, QueryPlan, plan_query
from repro_torch.core.patterns import BGP
from repro_torch.core.server import log_factor, unit_io
from repro_torch.rdf.store import StoreArrays, TripleStore, resolve_device


class DistStats(NamedTuple):
    """Per-lane traffic account (analytic, device scalars)."""

    rounds: torch.Tensor  # exchange rounds (the NRS analogue)
    gathered_rows: torch.Tensor  # rows crossing the network (NTB analogue)
    # bytes an all_gather of every shard's trimmed block would move (rows
    # with the provenance column, plus the validity byte): the paper's
    # NTB analogue, a formula, not a measurement of this card
    gathered_bytes: torch.Tensor
    server_ops: torch.Tensor
    n_results: torch.Tensor
    overflow: torch.Tensor  # bool


@dataclass(frozen=True)
class DistConfig:
    """The sharded lane's sizes and options.  The reference's
    ``data_axis``, ``model_axis`` and ``pod_axis`` name mesh axes, which
    this port does not have: the shard count is
    ``DistributedEngine(n_shards=...)`` and lanes are a loop."""

    cap: int = 2048  # per-lane table capacity
    shard_cap: int = 1024  # per-shard gather budget (trimmed to cap)
    # route bound-subject probes through the owner-masked probe: a row
    # can only match on the shard its subject hashes to, so every other
    # shard gives it the empty run without searching for its upper bound
    owner_masking: bool = False


def _lane_eval(plans: tuple, n_vars: int, cfg: DistConfig, radix: int,
               devs: list[StoreArrays], logn: int, const_vec: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, DistStats]:
    """Evaluate one query lane against every shard, merging the shards'
    results after every unit.

    ``devs`` holds each shard's arrays, ``const_vec`` the lane's
    constants and ``logn`` the *global* store's log-factor (the account
    must match the serial engine's).  Each unit is the shard-local,
    exchange-free ``stepper.eval_unit_sharded`` followed by one
    order-restoring k-way merge keyed by the provenance column and the
    unit's drawn-value columns, so the lane's rows are byte-identical to
    the serial engine's.  Returns ``(rows, valid, stats)``.
    """
    width = max(n_vars, 1)
    device = const_vec.device
    table = unit_table(cfg.cap, width, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    rounds = g_rows = g_bytes = server_ops = zero
    overflow = table.overflow
    trim = min(cfg.shard_cap, cfg.cap)
    prov = torch.arange(cfg.cap, dtype=torch.int32, device=device)[:, None]
    for up in plans:
        # server side: shard-local unit evaluation, no exchange
        seeded = BindingTable(torch.cat([table.rows, prov], dim=1),
                              table.valid, overflow)
        local, ops, _, cnt, ovf = stepper.eval_unit_sharded(
            devs, radix, up, const_vec, seeded, logn=logn,
            owner=cfg.owner_masking)
        server_ops = server_ops + ops
        # the network: shard-local results back to the client lane, in
        # serial order (provenance column + drawn-value columns)
        sort_cols = (width,) + tuple(unit_io(up).write_cols)
        rows_m, valid_m, lost = stepper.gather_merge_kway(
            [(t.rows, t.valid) for t in local], sort_cols, cfg.cap, trim)
        overflow = ovf | lost
        table = BindingTable(rows_m[:, :-1], valid_m, overflow)
        rounds = rounds + 1
        g_rows = g_rows + cnt
        g_bytes = g_bytes + len(devs) * trim * ((width + 1) * 4 + 1)
    stats = DistStats(rounds=rounds, gathered_rows=g_rows,
                      gathered_bytes=g_bytes, server_ops=server_ops,
                      n_results=table.count(), overflow=overflow)
    return table.rows, table.valid, stats


def _by_signature(plans: list[QueryPlan]) -> dict[tuple, list[int]]:
    """The indices of ``plans`` bucketed by plan signature, in order."""
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(plans):
        groups.setdefault(p.signature, []).append(i)
    return groups


class DistributedEngine:
    """Batched query engine over a subject-hash-sharded store, for one
    interface granularity.

    ``n_shards`` is the shard count (the reference mesh's ``data``
    extent) and ``device`` where the stacked shards live and the lanes
    run: the card unless the caller passes ``"cpu"``.  A *step* evaluates
    a batch of structurally identical queries (one plan signature), one
    lane each, lane by lane.
    """

    def __init__(self, store: TripleStore, cfg: EngineConfig,
                 dcfg: DistConfig | None = None, *, n_shards: int,
                 device=None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.store = store
        self.cfg = cfg
        self.dcfg = dcfg or DistConfig()
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)
        self._cache: dict = {}

    @property
    def _stacked(self) -> StoreArrays:
        """The sharded store's tensors for the current epoch (the store
        caches them per shard count and device, keeps the base resident
        across delta-only epochs and drops them on a base change)."""
        return self.store.stacked_shard_arrays(self.n_shards, self.device)

    # -------------------------------------------------------------- planning
    def plan_batch(self, queries: list[BGP]) -> tuple[QueryPlan, np.ndarray]:
        """Plan a batch; all queries must share the plan signature."""
        plans = [plan_query(self.store, q, self.cfg) for q in queries]
        sig = plans[0].signature
        for p in plans[1:]:
            if p.signature != sig:
                raise ValueError(
                    "plan_batch requires a plan-homogeneous batch; "
                    "run_batch buckets mixed batches by signature itself")
        consts = np.stack([np.asarray(p.consts, np.int64) for p in plans])
        return plans[0], consts

    def group_by_signature(self, queries: list[BGP]) -> dict[tuple, list[BGP]]:
        plans = [plan_query(self.store, q, self.cfg) for q in queries]
        return {sig: [queries[i] for i in idxs]
                for sig, idxs in _by_signature(plans).items()}

    # -------------------------------------------------------------- execution
    def make_step(self, plan: QueryPlan, batch: int):
        """The step for ``batch`` lanes of ``plan``'s signature:
        ``step(stacked, consts[batch, n_consts]) -> (rows[batch, cap, V],
        valid[batch, cap], DistStats of [batch])``, lane by lane."""
        dcfg = self.dcfg
        radix = self.store.radix
        logn = log_factor(self.store.n_triples)  # the GLOBAL store's factor

        def step(stacked: StoreArrays, consts: torch.Tensor):
            if consts.shape[0] != batch:
                raise ValueError(f"step built for {batch} lanes, got "
                                 f"{consts.shape[0]}")
            devs = [StoreArrays(*(a[i] for a in stacked))
                    for i in range(stacked.key_ps_pso.shape[0])]
            outs = [_lane_eval(plan.units, plan.n_vars, dcfg, radix, devs,
                               logn, consts[j]) for j in range(batch)]
            return (torch.stack([o[0] for o in outs]),
                    torch.stack([o[1] for o in outs]),
                    DistStats(*(torch.stack(list(f))
                                for f in zip(*(o[2] for o in outs)))))

        return step

    def run_batch(self, queries: list[BGP]):
        """Evaluate a batch of queries, one lane each.

        A plan-homogeneous batch runs as one step and returns stacked
        ``(rows[B, cap, V], valid[B, cap], DistStats of [B])``.  A mixed
        batch is bucketed by plan signature, each bucket run as its own
        step, and returns per-query *lists* in input order (entries of
        different signatures have different widths).
        """
        plans = [plan_query(self.store, q, self.cfg) for q in queries]
        groups = _by_signature(plans)
        out: dict[int, tuple] = {}
        for idxs in groups.values():
            consts = np.stack([np.asarray(plans[i].consts, np.int64)
                               for i in idxs])
            step = self._get_step(plans[idxs[0]], consts.shape[0])
            rows, valid, stats = step(
                self._stacked, torch.from_numpy(consts).to(self.device))
            if len(groups) == 1:
                return rows, valid, stats
            for lane, i in enumerate(idxs):
                out[i] = (rows[lane], valid[lane],
                          DistStats(*(f[lane] for f in stats)))
        ordered = [out[i] for i in range(len(queries))]
        return ([r for r, _, _ in ordered], [v for _, v, _ in ordered],
                [s for _, _, s in ordered])

    def _get_step(self, plan: QueryPlan, batch: int):
        # the store epoch is part of the key: make_step bakes the *logical*
        # triple count's log-factor into the lane closure, and a
        # tombstone-only delta changes it without changing any shape
        key = (plan.signature, batch, self.store.epoch)
        if key not in self._cache:
            self._cache[key] = self.make_step(plan, batch)
        return self._cache[key]

    def run_load(self, queries: list[BGP], scheduler=None):
        """Serving a load through the scheduler's sharded waves is the
        reference's ``run_load``; it is not ported yet."""
        raise NotImplementedError(
            "DistributedEngine.run_load serves through the scheduler's "
            "sharded waves, which come with port slice 5b; use run_batch, "
            "or QueryEngine.run_load on the whole store")
