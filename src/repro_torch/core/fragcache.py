"""Shared star-fragment cache: seeded unit requests as reusable responses.

brTPF's bindings-restricted requests were motivated in part by their
cacheability, and SPF inherits the property at star granularity: a seeded
unit evaluation is a pure function of

    (canonical unit structure, constant values, Omega block, capacity,
     store epoch)

— exactly ``server.unit_request_key``.  This module caches the *response*
of such a request in a replayable delta form, so a repeated star/bind
request — same query from another simulated client, a shared star across
different queries, a re-issued block — is served without touching the
store at all.  The scheduler (``core/scheduler.py``) consults the cache
between unit steps and folds the exact savings into ``QueryStats``
(``cache_hits`` / ``cache_misses`` / ``nrs_saved`` / ``ntb_saved``).

Sharing and invalidation
------------------------
One ``FragmentCache`` may be shared across scheduler instances: the
cache is host-side state consulted between device steps, so sharing
costs nothing beyond passing the same object around.  Correctness under
sharing rests on epochs: every entry is tagged with the **store epoch**
it was computed against (``TripleStore.epoch``), and a lookup presents
the current epoch.  A store mutation bumps the epoch, after which stale
entries are invalidated *lazily* — dropped the moment a lookup touches
them (counted in ``stats.stale_evictions``) — or eagerly by
``sync_epoch``, which carries over the entries whose predicates the
delta did not touch.  The epoch is also folded into the request key
itself, so cross-epoch collisions cannot alias even if a caller skips
the lookup-time check.

Admission
---------
Size-capped LRU alone lets a one-shot scan (a long-tail load's unique
fragments) wash the hot working set out of the cache.  The default
``policy="freq"`` adds TinyLFU-style admission on top of LRU *eviction*:
the cache keeps a compact frequency sketch of every key it has been asked
for, and at capacity a new entry is admitted only if its observed request
frequency is at least the LRU victim's — otherwise the insertion is
rejected (``stats.admission_rejects``) and the resident entry survives.
The sketch ages by periodic halving so stale popularity decays.
``policy="lru"`` admits every entry (plain LRU).

The default sketch is a constant-space **count-min sketch**
(``sketch="cms"``: depth x width counter matrix, min-over-rows estimate,
halving decay after a fixed window of touches) — its memory never grows
with the key population, unlike the exact per-hash dict it replaced.
``sketch="exact"`` keeps that dict (halving when the distinct-hash count
overflows) as the admission ground truth: on traces short of both decay
triggers and free of CMS collisions the two make identical admission
decisions, which is what the parity test pins.

Empty fragments get a dedicated side table: a negative result is a
zero-row delta, so caching it in the main map would spend a whole entry
slot (and admission pressure) on ~0 bytes of payload.  ``put`` routes
``n_out == 0`` entries into the negative table (own capacity, always
admitted, LRU-bounded); hits there are real hits — counted in
``stats.hits`` *and* ``stats.neg_hits`` — and replay to the empty table
for free.

Replay correctness
------------------
An entry stores, for the ``n_out`` valid output rows of the unit: the
source row index into the input's valid prefix (provenance, tracked by the
scheduler through an extra table column), the values written into the
unit's write columns, the true ops count and the overflow delta.  The
valid region of a unit's output is a pure function of the valid region of
its input (invalid-row garbage never influences a valid output row — see
``bindings.expand``), so replaying a delta reproduces the computed valid
rows byte-for-byte.  The replayed table's *invalid* region is refilled
with the UNBOUND sentinel rather than the compute path's garbage; nothing
downstream reads it.

Entries are only recorded from lanes whose input overflow flag is clear,
so ``entry.overflow`` is exactly the unit's own overflow contribution and
ORs correctly into any seed.

This module is host-side numpy, a copy of the JAX reference's
``core/fragcache.py``; the wire seam (``export_state`` / ``adopt``) is
not part of this package yet.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

from repro_torch.obs.registry import RegistryView


# --------------------------------------------------------------------------
# frequency sketches (TinyLFU admission support)
# --------------------------------------------------------------------------
#
# Both sketches count by ``hash(key)``, not the key itself: request keys
# embed Omega digests/bytes, and a long-tail scan of one-shot keys would
# otherwise park thousands of fat tuples in the sketch — the very workload
# admission exists to survive.  Collisions merely inflate an approximate
# count.

class ExactFreqSketch:
    """The exact per-hash dict sketch: unbounded-ish —
    memory grows with the distinct-key population until the halving
    trigger (distinct hashes > 8x capacity) decays and drops zeros.
    Kept as the admission ground truth for the CMS parity test."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._freq: dict = {}

    def add(self, key: tuple) -> int:
        h = hash(key)
        f = self._freq.get(h, 0) + 1
        self._freq[h] = f
        if len(self._freq) > 8 * self.capacity:
            self._freq = {k: v // 2 for k, v in self._freq.items() if v >= 2}
        return f

    def estimate(self, key: tuple) -> int:
        return self._freq.get(hash(key), 0)

    def clear(self) -> None:
        self._freq.clear()


def _smix64(x: int) -> int:
    """splitmix64 finaliser on python ints (mod 2^64)."""
    m = 0xFFFFFFFFFFFFFFFF
    x &= m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


class CountMinSketch:
    """Constant-space count-min sketch with halving decay (TinyLFU aging).

    ``depth`` salted rows of ``width`` uint32 counters (width: pow2 >=
    4x cache capacity); an estimate is the min over rows, so collisions
    can only inflate counts.  After ``16 x capacity`` touches every
    counter halves — the same aging intent as the exact sketch's
    halve-and-drop, bounded in touches instead of distinct keys (the
    quantity a CMS cannot observe).  Counters cannot overflow: a counter
    is bumped at most once per touch and the decay window caps touches.
    """

    DEPTH = 4
    _SALTS = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F,
              0x165667B19E3779F9, 0x27D4EB2F165667C5)

    def __init__(self, capacity: int):
        width = 1 << max(8, (4 * capacity - 1).bit_length())
        self._mask = width - 1
        self._table = np.zeros((self.DEPTH, width), np.uint32)
        self._window = 16 * capacity
        self._touches = 0

    def _slots(self, key: tuple) -> list[int]:
        h = hash(key) & 0xFFFFFFFFFFFFFFFF
        return [_smix64(h ^ s) & self._mask for s in self._SALTS]

    def add(self, key: tuple) -> int:
        slots = self._slots(key)
        for d, i in enumerate(slots):
            self._table[d, i] += 1
        self._touches += 1
        if self._touches >= self._window:
            self._table >>= 1
            self._touches = 0
        return int(min(self._table[d, i] for d, i in enumerate(slots)))

    def estimate(self, key: tuple) -> int:
        return int(min(self._table[d, i]
                       for d, i in enumerate(self._slots(key))))

    def clear(self) -> None:
        self._table[:] = 0
        self._touches = 0


class FragmentEntry(NamedTuple):
    """Replayable response of one seeded unit request."""

    src_row: np.ndarray  # int32[n_out] index into the input valid prefix
    written: np.ndarray  # int32[n_out, n_write] values for the write cols
    overflow: bool  # the unit's own overflow contribution
    ops: int  # server work units the evaluation cost
    epoch: int = 0  # store epoch the fragment was computed against
    # the unit's true peak row count (max branch-boundary count of the
    # recorded evaluation) — replayed units feed it to the capacity
    # planner's high-water marks just like computed ones
    peak: int = 0

    @property
    def n_out(self) -> int:
        return int(self.src_row.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.src_row.nbytes + self.written.nbytes)


# shared zero-row arrays for negative-table reconstruction (replay only
# reads shapes/values of the valid prefix, which is empty here)
_EMPTY_SRC = np.zeros((0,), np.int32)
_EMPTY_WRITTEN = np.zeros((0, 0), np.int32)


class CacheStats(RegistryView):
    """Cache tallies as ``cache.*`` registry instruments
    (``obs.registry.RegistryView``), snapshot-able through the backing
    ``MetricsRegistry`` alongside the scheduler's and planner's
    instruments when the three share one registry."""

    _PREFIX = "cache"
    _FIELDS = (
        "hits",  # lookups served from a stored entry (incl. negative)
        "neg_hits",  # the subset of hits served by the negative table
        "shared_hits",  # requests collapsed onto an identical in-flight one
        "misses",
        "insertions",
        "neg_insertions",
        "evictions",
        "neg_evictions",  # LRU drops from the negative side table
        "stale_evictions",  # entries dropped because their epoch lapsed
        # epoch-sweep outcome split (obs-gated like every instrument):
        # entries whose predicates were untouched by a delta epoch are
        # re-keyed to the new epoch instead of dropped...
        "carryover",
        # ...and the touched (or unattributable) remainder is dropped —
        # counted here as well as in stale_evictions (swept is the
        # sweep-only subset; get()-time lazy drops are stale-only)
        "swept",
        "admission_rejects",  # freq policy kept the victim, refused the new
        "bytes_stored",
    )

    @property
    def total_hits(self) -> int:
        return self.hits + self.shared_hits

    @property
    def hit_rate(self) -> float:
        total = self.total_hits + self.misses
        return self.total_hits / total if total else 0.0


@dataclass
class FragmentCache:
    """Shared map from canonical unit requests to replayable fragment deltas.

    ``capacity`` bounds the main entry count; ``max_entry_rows`` skips
    caching pathologically fat fragments (a single huge expansion would
    evict the whole working set for one unlikely-to-repeat key).
    ``neg_capacity`` bounds the negative side table.  ``policy`` selects
    admission: ``"freq"`` (TinyLFU-style, the default) or ``"lru"``
    (admit always).  ``sketch`` selects the frequency sketch backing
    ``"freq"``: ``"cms"`` (constant-space count-min with halving decay,
    the default) or ``"exact"`` (the per-hash dict — the parity
    baseline).
    """

    capacity: int = 4096
    max_entry_rows: int = 1 << 20
    neg_capacity: int = 16384
    policy: str = "freq"  # "freq" | "lru"
    sketch: str = "cms"  # "cms" | "exact"
    # shared MetricsRegistry to mount the cache.* instruments on (a
    # scheduler that builds its own cache passes its registry so cache
    # stats land in the same snapshot as SchedMetrics); None = private
    registry: object = None
    _entries: OrderedDict = field(default_factory=OrderedDict, repr=False)
    _neg: OrderedDict = field(default_factory=OrderedDict, repr=False)
    _sketch: object = field(default=None, repr=False)
    _swept_epoch: int = field(default=0, repr=False)
    stats: CacheStats = None

    def __post_init__(self):
        if self.policy not in ("freq", "lru"):
            raise ValueError(f"unknown admission policy {self.policy!r}")
        if self.sketch not in ("cms", "exact"):
            raise ValueError(f"unknown frequency sketch {self.sketch!r}")
        self._sketch = CountMinSketch(self.capacity) if self.sketch == "cms" \
            else ExactFreqSketch(self.capacity)
        if self.stats is None:
            self.stats = CacheStats(self.registry)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def n_negative(self) -> int:
        return len(self._neg)

    # ---------------------------------------------------------------- lookups
    def get(self, key: tuple, epoch: int = 0) -> FragmentEntry | None:
        """Look up a canonical request at the current store ``epoch``.

        An entry recorded under an older epoch is stale: it is dropped on
        touch (lazy invalidation — no flush) and the lookup misses.

        Invariant: the scheduler's keys (``server.unit_request_key`` /
        ``unit_digest_key``) fold the epoch into the key itself, so for
        them a stale entry is simply *unreachable* — this get-time check
        can only ever fire for callers using raw or epoch-less keys, and
        the scheduler relies on the eager ``sync_epoch`` sweep (not this
        branch) to reclaim stale memory.  The branch is kept as the
        correctness backstop for raw-key users of the public API and is
        pinned by an explicit raw-key probe test.
        """
        if self.policy == "freq":  # plain LRU never consults the sketch
            self._sketch.add(key)
        entry = self._entries.get(key)
        if entry is not None:
            if entry.epoch != epoch:
                del self._entries[key]
                self.stats.stale_evictions += 1
                self.stats.bytes_stored -= entry.nbytes
                self.stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return entry
        neg = self._neg.get(key)
        if neg is not None:
            neg_overflow, neg_ops, neg_epoch, neg_peak = neg
            if neg_epoch != epoch:
                del self._neg[key]
                self.stats.stale_evictions += 1
                self.stats.misses += 1
                return None
            self._neg.move_to_end(key)
            self.stats.hits += 1
            self.stats.neg_hits += 1
            return FragmentEntry(_EMPTY_SRC, _EMPTY_WRITTEN, neg_overflow,
                                 neg_ops, neg_epoch, neg_peak)
        self.stats.misses += 1
        return None

    @property
    def synced_epoch(self) -> int:
        """The store epoch this cache last swept against — callers use it
        to ask the store which predicates changed since
        (``TripleStore.changed_preds_since``) for warm carry-over."""
        return self._swept_epoch

    def sync_epoch(self, epoch: int, changed_preds=None) -> int:
        """Observe the store epoch; sweep stale entries on first sight of
        a new one.  Returns the number of entries dropped.

        ``changed_preds`` is the set of predicate ids touched since the
        last sweep (``TripleStore.changed_preds_since``), or ``None`` when
        unknown.  With it, entries none of whose constant values
        (``key[1]`` — every branch predicate a unit reads is among them)
        intersect the changed set are **carried over**: re-keyed to the
        new epoch in place of being dropped, so a delta touching predicate
        ``p`` leaves fragments over other predicates warm.  The test is
        conservative — a non-predicate constant colliding with a changed
        predicate id merely causes a byte-safe extra sweep.  ``None``
        keeps the legacy sweep-everything behaviour.

        The sweep state lives on the cache, not its callers, because the
        shared cache outlives any one scheduler: a scheduler created
        *after* a bump must still trigger the reclamation of fragments
        recorded before it existed.  Every drain calls this; it is a
        no-op while the epoch is unchanged.
        """
        if epoch == self._swept_epoch:
            return 0
        self._swept_epoch = epoch
        if changed_preds is None:
            n = self.invalidate_stale(epoch)
            self.stats.swept += n
            return n

        changed = frozenset(changed_preds)

        def _carries(key) -> bool:
            return changed.isdisjoint(key[1])

        def _rekey(key):
            return key[:3] + (epoch,) + key[4:]

        dropped = 0
        entries = OrderedDict()
        for k, e in self._entries.items():
            if e.epoch == epoch:
                entries[k] = e
            elif _carries(k):
                entries[_rekey(k)] = e._replace(epoch=epoch)
                self.stats.carryover += 1
            else:
                dropped += 1
                self.stats.bytes_stored -= e.nbytes
        self._entries = entries
        neg = OrderedDict()
        for k, (ovf, ops, ep, peak) in self._neg.items():
            if ep == epoch:
                neg[k] = (ovf, ops, ep, peak)
            elif _carries(k):
                neg[_rekey(k)] = (ovf, ops, epoch, peak)
                self.stats.carryover += 1
            else:
                dropped += 1
        self._neg = neg
        self.stats.stale_evictions += dropped
        self.stats.swept += dropped
        return dropped

    def invalidate_stale(self, epoch: int) -> int:
        """Drop every entry not tagged with ``epoch``; returns the count.

        The eager half of epoch invalidation (``sync_epoch`` calls this on
        the first drain after a store-epoch change), reclaiming stale
        fragments' memory at once.  Entries recorded at the current epoch,
        the stats counters and the frequency sketch all survive — this is
        not a flush.  (The lookup-time epoch check in ``get`` remains as
        the lazy backstop for sharers that have not swept yet.)
        """
        stale = [k for k, e in self._entries.items() if e.epoch != epoch]
        for k in stale:
            self.stats.bytes_stored -= self._entries.pop(k).nbytes
        stale_neg = [k for k, (_, _, ep, _) in self._neg.items()
                     if ep != epoch]
        for k in stale_neg:
            del self._neg[k]
        n = len(stale) + len(stale_neg)
        self.stats.stale_evictions += n
        return n

    def note_shared_hit(self, n: int = 1) -> None:
        """Account requests served by collapsing onto an identical in-flight
        request (the concurrent analogue of a cache hit: the response is
        computed once and fanned out, the server sees one request)."""
        self.stats.shared_hits += n

    # -------------------------------------------------------------- insertion
    def put(self, key: tuple, entry: FragmentEntry, epoch: int = 0) -> None:
        if entry.epoch != epoch:
            entry = entry._replace(epoch=epoch)
        if entry.n_out == 0:
            # negative result: zero-row delta, cached in the side table so
            # it never competes with real fragments for capacity
            if key in self._neg:
                return
            self._neg[key] = (entry.overflow, entry.ops, epoch, entry.peak)
            self.stats.neg_insertions += 1
            while len(self._neg) > self.neg_capacity:
                self._neg.popitem(last=False)
                # side-table churn is its own instrument: charging it to
                # the main ``evictions`` counter polluted the eviction
                # accounting TinyLFU tuning reads (a negative flood looked
                # like main-cache thrash)
                self.stats.neg_evictions += 1
            return
        if entry.n_out > self.max_entry_rows or key in self._entries:
            return
        if self.policy == "freq" and len(self._entries) >= self.capacity:
            # TinyLFU admission: the newcomer must be at least as popular
            # as the LRU victim it would displace, else keep the resident
            victim_key = next(iter(self._entries))
            new_f = self._sketch.estimate(key) or 1
            victim_f = self._sketch.estimate(victim_key)
            if new_f < victim_f:
                self.stats.admission_rejects += 1
                return
        self._entries[key] = entry
        self.stats.insertions += 1
        self.stats.bytes_stored += entry.nbytes
        while len(self._entries) > self.capacity:
            _, old = self._entries.popitem(last=False)
            self.stats.evictions += 1
            self.stats.bytes_stored -= old.nbytes

    def clear(self) -> None:
        """Drop entries, sketch and counters (fresh measurement epoch)."""
        self._entries.clear()
        self._neg.clear()
        self._sketch.clear()
        self.stats.reset()


def replay(entry: FragmentEntry, in_rows_valid: np.ndarray, cap: int,
           n_vars: int, write_cols: tuple[int, ...]
           ) -> tuple[np.ndarray, np.ndarray]:
    """Materialise a cached fragment onto a seed's valid prefix.

    ``in_rows_valid`` is the input table's valid prefix ``[n_in, n_vars]``;
    returns the full-capacity ``(rows, valid)`` pair for the next unit step
    (invalid region UNBOUND-filled — see module docstring).
    """
    rows = np.full((cap, n_vars), -1, dtype=np.int32)
    n_out = entry.n_out
    if n_out:
        out = in_rows_valid[entry.src_row]
        if write_cols:
            out[:, list(write_cols)] = entry.written
        rows[:n_out] = out
    valid = np.zeros((cap,), dtype=bool)
    valid[:n_out] = True
    return rows, valid
