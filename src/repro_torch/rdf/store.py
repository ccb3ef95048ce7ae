"""HDT-style triple store: sorted permutation indexes over dictionary ids.

Layout
------
Triples are dictionary-encoded ``(s, p, o)`` int32 triples.  Two sort
orders are materialised (the SPF server's access paths need exactly
these two):

- **PSO order** — sorted by ``(p, s, o)``.  A predicate's triples form a
  contiguous run (CSR ``pred_offsets``); within the run subjects are
  sorted, so ``(?s, p, ?o)`` yields a *sorted* subject list and
  ``(s, p, ?o)`` is a binary-search run.
- **POS order** — sorted by ``(p, o, s)``.  ``(?s, p, o)`` is a
  binary-search run whose subjects are sorted.

Composite int64 keys (``p*R + s`` etc.) make every lookup a batched
binary search; radix overflow is checked at build time.

The store keeps **numpy** arrays for host-side query planning (join
ordering uses exact run lengths — the Def. 6 cardinality metadata with
eps = 0) and a **torch** view on a chosen device for evaluation
(``device_arrays``).  The base index costs 32 bytes per triple on the
device: two int64 key columns and four int32 value columns.

Write path: the delta overlay
-----------------------------
The base index is immutable (``compact`` rebuilds it wholesale); the
store is writable through a sorted delta overlay (``apply_delta`` /
``insert_triples`` / ``delete_triples``):

- **inserts** live in a second pair of sorted runs in the same PSO/POS
  composite-key layout (``h_ins_key_ps`` ...), disjoint from the live
  base;
- **deletes** of base triples become **tombstones**: sorted base
  positions per order (``h_tomb_pos_ps`` / ``h_tomb_pos_po``) and the
  nondecreasing ``pos - rank`` column (``h_tomb_adj_*``) that turns
  "k-th live base row" into one ``searchsorted``.

The logical triple set is ``base - tombstones + inserts``;
``n_triples`` counts it and ``n_base`` is the physical base length.

Epochs: ``epoch`` advances on every logical change, ``base_epoch`` only
when the base arrays change (``compact``, ``bump_epoch``).  The device
view splits the same way: the six base tensors are uploaded once per
device and base epoch and stay resident across delta-only epochs; the
ten delta tensors are uploaded per epoch at their **exact** lengths.
(The JAX reference pads every delta column to one stable power-of-two
bucket so that jit traces once per compaction cycle; the port runs
eagerly, has nothing to retrace, and uploads no padding.  A zero-length
column is the "no such delta" case the evaluators test for.)  Each bump
logs the predicates it touched (``changed_preds_since``).  The
dictionary is fixed: inserts must use existing term and predicate ids.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

_HOST_FIELDS = ("h_key_ps", "h_s_pso", "h_o_pso", "h_key_po", "h_s_pos",
                "h_o_pos", "h_pred_offsets")
_HOST_DTYPES = (np.int64, np.int32, np.int32, np.int64, np.int32, np.int32,
                np.int64)
_DELTA_FIELDS = ("h_ins_key_ps", "h_ins_s_pso", "h_ins_o_pso",
                 "h_ins_key_po", "h_ins_s_pos", "h_ins_o_pos",
                 "h_tomb_pos_ps", "h_tomb_adj_ps", "h_tomb_pos_po",
                 "h_tomb_adj_po")
_EPOCH_LOG_MAX = 64


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller
    names another.  Raises when the card is asked for and there is none —
    the CPU is taken only when the caller passes ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class StoreArrays(NamedTuple):
    """Device-resident index tensors: the six base columns, resident per
    base epoch, and the ten delta columns at their exact lengths (``m``
    inserts, ``t`` tombstones; zero-length where there are none)."""

    # PSO order (base)
    key_ps_pso: torch.Tensor  # int64[n]  p*R_term + s, ascending
    s_pso: torch.Tensor  # int32[n]
    o_pso: torch.Tensor  # int32[n]
    # POS order (base)
    key_po_pos: torch.Tensor  # int64[n]  p*R_term + o, ascending
    s_pos: torch.Tensor  # int32[n]
    o_pos: torch.Tensor  # int32[n]  (object of each POS row; run-constant)
    # delta: inserts, PSO order
    ins_key_ps: torch.Tensor  # int64[m]  ascending
    ins_s_pso: torch.Tensor  # int32[m]
    ins_o_pso: torch.Tensor  # int32[m]
    # delta: inserts, POS order
    ins_key_po: torch.Tensor  # int64[m]  ascending
    ins_s_pos: torch.Tensor  # int32[m]
    ins_o_pos: torch.Tensor  # int32[m]
    # delta: tombstones (sorted base positions + pos-rank columns)
    tomb_pos_ps: torch.Tensor  # int32[t]  ascending PSO positions
    tomb_adj_ps: torch.Tensor  # int32[t]  tomb_pos - arange(t), nondecreasing
    tomb_pos_po: torch.Tensor  # int32[t]  ascending POS positions
    tomb_adj_po: torch.Tensor  # int32[t]


def _rows(batch) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """An ``(s, p, o)`` batch as three aligned int64 arrays, returned in
    ``(p, s, o)`` order."""
    s, p, o = (np.asarray(a, np.int64).ravel() for a in batch)
    if s.shape != p.shape or s.shape != o.shape:
        raise ValueError("insert/delete arrays must align")
    return p, s, o


def _sorted_rows(triples) -> np.ndarray:
    """A set of ``(p, s, o)`` tuples as an int64[k, 3] array in ascending
    ``(p, s, o)`` order (what ``sorted`` of the set gives)."""
    a = np.array(list(triples), np.int64).reshape(-1, 3)
    return a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]


def _run_lower_bound(col: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                     x: np.ndarray) -> np.ndarray:
    """Per-row ``lo + #{k in [lo, hi) : col[k] < x}`` over sorted runs,
    by one vectorised bisection (rows whose run is empty keep ``lo``)."""
    lo = lo.astype(np.int64)
    hi = hi.astype(np.int64)
    while True:
        live = lo < hi
        if not live.any():
            return lo
        mid = (lo + hi) >> 1
        go = live & (col[np.minimum(mid, col.shape[0] - 1)] < x)
        lo = np.where(go, mid + 1, lo)
        hi = np.where(live & ~go, mid, hi)


@dataclass
class TripleStore:
    """Dictionary-id triple store: immutable PSO/POS base + delta overlay.

    ``n_triples`` is the **logical** live count (base - tombstones +
    inserts); ``n_base`` the physical base length.  The ``h_*`` arrays
    are the base index; the delta lives in ``h_ins_*`` / ``h_tomb_*``,
    re-derived from the canonical insert and tombstone sets on every
    effective ``apply_delta`` (delta-sized work, never a base re-sort).
    ``device_arrays(device)`` gives the torch view.
    """

    n_triples: int
    n_terms: int  # radix for subject/object ids (shared id space)
    n_predicates: int
    # host (numpy) copies for planning
    h_key_ps: np.ndarray
    h_s_pso: np.ndarray
    h_o_pso: np.ndarray
    h_key_po: np.ndarray
    h_s_pos: np.ndarray
    h_o_pos: np.ndarray
    h_pred_offsets: np.ndarray  # int64[n_predicates + 2] CSR (PSO==POS runs)
    # mutation epoch: advanced on every logical change (a delta, a
    # compaction, ``bump_epoch``) and folded into the capacity planner's
    # high-water-mark keys, so observations made against other contents
    # never alias
    epoch: int = 0
    # physical base length (== n_triples while the delta is empty);
    # -1 = derive from n_triples in __post_init__
    n_base: int = -1
    # advanced only when the base arrays change (compact, bump_epoch):
    # versions the resident base upload and the planner's base degrees
    base_epoch: int = 0
    # canonical delta state: sets of (p, s, o) int tuples
    _ins_set: set = field(default_factory=set, repr=False)
    _tomb_set: set = field(default_factory=set, repr=False)
    # sorted delta columns derived from the sets (see _rebuild_delta)
    h_ins_key_ps: np.ndarray | None = field(default=None, repr=False)
    h_ins_s_pso: np.ndarray | None = field(default=None, repr=False)
    h_ins_o_pso: np.ndarray | None = field(default=None, repr=False)
    h_ins_key_po: np.ndarray | None = field(default=None, repr=False)
    h_ins_s_pos: np.ndarray | None = field(default=None, repr=False)
    h_ins_o_pos: np.ndarray | None = field(default=None, repr=False)
    h_tomb_pos_ps: np.ndarray | None = field(default=None, repr=False)
    h_tomb_adj_ps: np.ndarray | None = field(default=None, repr=False)
    h_tomb_pos_po: np.ndarray | None = field(default=None, repr=False)
    h_tomb_adj_po: np.ndarray | None = field(default=None, repr=False)
    # (epoch, frozenset of touched predicate ids | None) per bump, bounded
    _epoch_log: list = field(default_factory=list, repr=False)
    # device views keyed by torch.device: the base as (base_epoch,
    # tensors), the whole view as (epoch, StoreArrays)
    _dev_base: dict = field(default_factory=dict, repr=False)
    _device: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.n_base < 0:
            self.n_base = self.n_triples
        if self.h_ins_key_ps is None:
            self._rebuild_delta()

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(s: np.ndarray, p: np.ndarray, o: np.ndarray,
              n_terms: int | None = None,
              n_predicates: int | None = None) -> "TripleStore":
        s = np.asarray(s, dtype=np.int64)
        p = np.asarray(p, dtype=np.int64)
        o = np.asarray(o, dtype=np.int64)
        if n_terms is None:
            n_terms = int(max(s.max(initial=0), o.max(initial=0))) + 1
        if n_predicates is None:
            n_predicates = int(p.max(initial=0)) + 1
        r = np.int64(n_terms)
        # radix-overflow check: key = p * R + term must fit int64.
        if (n_predicates + 1) * int(r) >= 2**62:
            raise ValueError("composite key radix overflow; shard the dictionary")

        # deduplicate (RDF graphs are triple *sets*)
        pso = np.stack([p, s, o], axis=1)
        pso = np.unique(pso, axis=0)  # sorts lexicographically by (p, s, o)
        p_, s_, o_ = pso[:, 0], pso[:, 1], pso[:, 2]
        n = p_.shape[0]
        key_ps = p_ * r + s_

        order_pos = np.lexsort((s_, o_, p_))  # sort by (p, o, s)
        s_pos = s_[order_pos]
        o_pos = o_[order_pos]
        key_po = p_[order_pos] * r + o_pos

        # CSR over predicates (same boundaries in both orders).
        pred_offsets = np.searchsorted(p_, np.arange(n_predicates + 2))
        return TripleStore(
            n_triples=int(n),
            n_terms=int(n_terms),
            n_predicates=int(n_predicates),
            h_key_ps=key_ps,
            h_s_pso=s_.astype(np.int32),
            h_o_pso=o_.astype(np.int32),
            h_key_po=key_po,
            h_s_pos=s_pos.astype(np.int32),
            h_o_pos=o_pos.astype(np.int32),
            h_pred_offsets=pred_offsets.astype(np.int64),
        )

    @staticmethod
    def from_host_arrays(arrays, n_terms: int, n_predicates: int, *,
                         inserts=(), tombstones=(), epoch: int = 0,
                         base_epoch: int = 0) -> "TripleStore":
        """A store over an existing numpy index and delta overlay, as
        another build of it wrote them out.

        ``arrays`` maps the seven base index names (``h_key_ps``,
        ``h_s_pso``, ``h_o_pso``, ``h_key_po``, ``h_s_pos``, ``h_o_pos``,
        ``h_pred_offsets``) to numpy arrays laid out as ``build`` lays them
        out.  Types are pinned (keys and offsets int64, values int32) and
        shapes checked; the sort order is trusted, as ``build``'s is.

        The delta overlay comes as the canonical sets of ``(p, s, o)``
        triples (``inserts``, ``tombstones``: the other store's insert and
        tombstone sets); the delta columns are re-derived from them, and
        where ``arrays`` holds the ten columns as the other store derived
        them (``h_ins_key_ps`` ... ``h_tomb_adj_po``, exact lengths) they
        must be equal.  Every tombstone must be a base triple and no
        insert may be.  ``epoch`` and ``base_epoch`` carry the counters;
        the touched-predicate log starts empty, so ``changed_preds_since``
        of an earlier epoch is unknown (``None``).
        """
        host = {}
        for name, dt in zip(_HOST_FIELDS, _HOST_DTYPES):
            a = np.asarray(arrays[name])
            if a.ndim != 1:
                raise ValueError(f"{name} must be 1-D, got shape {a.shape}")
            host[name] = np.ascontiguousarray(a.astype(dt, copy=False))
        n = host["h_key_ps"].shape[0]
        if any(host[f].shape[0] != n for f in _HOST_FIELDS[:6]):
            raise ValueError("index columns must all have the same length")
        if host["h_pred_offsets"].shape[0] != n_predicates + 2:
            raise ValueError("h_pred_offsets must have n_predicates + 2 "
                             "entries")
        store = TripleStore(n_triples=int(n), n_terms=int(n_terms),
                            n_predicates=int(n_predicates), epoch=int(epoch),
                            base_epoch=int(base_epoch), **host)
        store._ins_set = {tuple(map(int, t)) for t in inserts}
        store._tomb_set = {tuple(map(int, t)) for t in tombstones}
        for name, rows, want in (("insert", store._ins_set, False),
                                 ("tombstone", store._tomb_set, True)):
            p, s, o = _sorted_rows(rows).T
            if not store._in_dictionary(p, s, o).all() or \
                    ((store._base_pos(p, s, o, "ps") >= 0) != want).any():
                raise ValueError(f"every {name} must {'' if want else 'not '}"
                                 f"be a base triple inside the dictionary")
        store._rebuild_delta()
        for f in _DELTA_FIELDS:
            if f in arrays and not np.array_equal(np.asarray(arrays[f]),
                                                  getattr(store, f)):
                raise ValueError(f"{f} does not match the delta sets")
        return store

    # ------------------------------------------------------------- device view
    def device_arrays(self, device=None) -> StoreArrays:
        """The index as tensors on ``device`` (default ``"cuda"``; raises
        where there is no card unless the caller passes ``"cpu"``).

        The counterpart of the JAX store's ``device`` property.  The six
        base tensors are uploaded once per device and base epoch and stay
        resident across delta-only epochs; the ten delta tensors are
        uploaded once per device and epoch at their exact lengths.  On
        the CPU the tensors share memory with the host arrays.
        """
        dev = resolve_device(device)
        cached = self._device.get(dev)
        if cached is not None and cached[0] == self.epoch:
            return cached[1]
        base = self._dev_base.get(dev)
        if base is None or base[0] != self.base_epoch:
            base = (self.base_epoch,
                    tuple(torch.from_numpy(getattr(self, f)).to(dev)
                          for f in _HOST_FIELDS[:6]))
            self._dev_base[dev] = base
        delta = (torch.from_numpy(getattr(self, f)).to(dev)
                 for f in _DELTA_FIELDS)
        arrays = StoreArrays(*base[1], *delta)
        self._device[dev] = (self.epoch, arrays)
        return arrays

    @property
    def radix(self) -> int:
        return self.n_terms

    # ------------------------------------------------------------------ epochs
    @property
    def delta_size(self) -> int:
        """Inserts + tombstones currently overlaid on the base."""
        return len(self._ins_set) + len(self._tomb_set)

    def bump_epoch(self) -> int:
        """Advance the epoch after an *external* change of the host
        arrays: the whole device view, base included, is dropped, and the
        bump is logged as touching an unknown predicate set, so callers
        of ``changed_preds_since`` sweep everything.  Returns the new
        epoch."""
        self.base_epoch += 1
        return self._bump(None, delta_only=False)

    def _bump(self, changed: frozenset | None, *, delta_only: bool) -> int:
        self.epoch += 1
        self._device.clear()
        if not delta_only:
            self._dev_base.clear()
        self._epoch_log.append((self.epoch, changed))
        if len(self._epoch_log) > _EPOCH_LOG_MAX:
            del self._epoch_log[0]
        return self.epoch

    def changed_preds_since(self, epoch: int) -> frozenset | None:
        """Union of predicate ids touched by every bump after ``epoch``.

        ``frozenset()`` when nothing changed (the epoch is current, or
        only content-preserving bumps such as compaction happened);
        ``None`` when the answer is unknown (an external ``bump_epoch`` in
        the window, or the bounded log no longer covers ``epoch``) —
        callers treat ``None`` as "everything changed".
        """
        if epoch == self.epoch:
            return frozenset()
        if epoch > self.epoch:
            return None
        acc: set = set()
        seen_down_to = self.epoch + 1
        for e, ch in reversed(self._epoch_log):
            if e <= epoch:
                break
            if e != seen_down_to - 1 or ch is None:
                return None  # gap in the log, or an unknown-change bump
            acc |= ch
            seen_down_to = e
        if seen_down_to != epoch + 1:
            return None  # the bounded log was truncated past `epoch`
        return frozenset(acc)

    # ------------------------------------------------------------- write path
    def _in_dictionary(self, p, s, o) -> np.ndarray:
        return ((p >= 0) & (p < self.n_predicates) & (s >= 0)
                & (s < self.n_terms) & (o >= 0) & (o < self.n_terms))

    def _base_pos(self, p: np.ndarray, s: np.ndarray, o: np.ndarray,
                  order: str) -> np.ndarray:
        """Base position of each triple in PSO (``order="ps"``) or POS
        (``"po"``) order, -1 where the triple is not in the base."""
        r = np.int64(self.n_terms)
        if order == "ps":
            keys, col, key, x = self.h_key_ps, self.h_o_pso, p * r + s, o
        else:
            keys, col, key, x = self.h_key_po, self.h_s_pos, p * r + o, s
        if col.shape[0] == 0:
            return np.full(p.shape, -1, np.int64)
        lo = np.searchsorted(keys, key, side="left")
        hi = np.searchsorted(keys, key, side="right")
        pos = _run_lower_bound(col, lo, hi, x)
        hit = (pos < hi) & (col[np.minimum(pos, col.shape[0] - 1)] == x)
        return np.where(hit & self._in_dictionary(p, s, o), pos, -1)

    def apply_delta(self, insert=None, delete=None) -> int:
        """Apply a write batch to the delta overlay; returns the epoch.

        ``insert`` / ``delete`` are ``(s, p, o)`` array triples like
        ``build``'s.  Deletes apply first, then inserts, with set
        semantics on the logical triple set: deleting an insert removes
        it, deleting a live base triple tombstones it, deleting an absent
        triple is a no-op; inserting a tombstoned triple cancels the
        tombstone, inserting a live triple is a no-op.  Ineffective
        batches do not bump the epoch.  Inserts must lie inside the fixed
        dictionary (``n_terms`` / ``n_predicates``): a batch with one
        outside raises before anything changes.

        Work is O(batch · log base + delta · log delta); the base is never
        re-sorted.  The bump is delta-only (the base stays resident on the
        device) and logs the touched predicate ids.
        """
        dels = None if delete is None else _rows(delete)
        ins = None if insert is None else _rows(insert)
        if ins is not None and not self._in_dictionary(*ins).all():
            bad = int(np.argmin(self._in_dictionary(*ins)))
            p, s, o = (int(a[bad]) for a in ins)
            raise ValueError(
                f"triple {(s, p, o)} outside the fixed dictionary "
                f"(n_terms={self.n_terms}, n_predicates={self.n_predicates});"
                f" growing the dictionary is a rebuild, not a delta")
        changed: set[int] = set()
        if dels is not None:
            in_base = (self._base_pos(*dels, "ps") >= 0).tolist()
            for t, b in zip(zip(*(a.tolist() for a in dels)), in_base):
                if t in self._ins_set:
                    self._ins_set.remove(t)
                    changed.add(t[0])
                elif b and t not in self._tomb_set:
                    self._tomb_set.add(t)
                    changed.add(t[0])
        if ins is not None:
            in_base = (self._base_pos(*ins, "ps") >= 0).tolist()
            for t, b in zip(zip(*(a.tolist() for a in ins)), in_base):
                if t in self._tomb_set:
                    self._tomb_set.remove(t)
                    changed.add(t[0])
                elif not b and t not in self._ins_set:
                    self._ins_set.add(t)
                    changed.add(t[0])
        if not changed:
            return self.epoch
        self._rebuild_delta()
        return self._bump(frozenset(changed), delta_only=True)

    def insert_triples(self, s, p, o) -> int:
        return self.apply_delta(insert=(s, p, o))

    def delete_triples(self, s, p, o) -> int:
        return self.apply_delta(delete=(s, p, o))

    def _rebuild_delta(self) -> None:
        """Re-derive the sorted delta columns from the canonical sets
        (delta-sized sorts and base lookups; the base is untouched)."""
        r = np.int64(self.n_terms)
        p_, s_, o_ = _sorted_rows(self._ins_set).T
        self.h_ins_key_ps = p_ * r + s_  # (p, s, o) order == PSO layout
        self.h_ins_s_pso = s_.astype(np.int32)
        self.h_ins_o_pso = o_.astype(np.int32)
        order_pos = np.lexsort((s_, o_, p_))
        self.h_ins_key_po = p_[order_pos] * r + o_[order_pos]
        self.h_ins_s_pos = s_[order_pos].astype(np.int32)
        self.h_ins_o_pos = o_[order_pos].astype(np.int32)
        # tombstones in (p, s, o) order enumerate base PSO positions in
        # ascending order; the POS positions need their own sort
        tp, ts, to = _sorted_rows(self._tomb_set).T
        pos_ps = self._base_pos(tp, ts, to, "ps").astype(np.int32)
        pos_po = np.sort(self._base_pos(tp, ts, to, "po")).astype(np.int32)
        rank = np.arange(pos_ps.shape[0], dtype=np.int32)
        self.h_tomb_pos_ps = pos_ps
        self.h_tomb_adj_ps = pos_ps - rank
        self.h_tomb_pos_po = pos_po
        self.h_tomb_adj_po = pos_po - rank
        self.n_triples = self.n_base - pos_ps.shape[0] + p_.shape[0]

    def merged_triples(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The logical triple set as ``(s, p, o)`` int64 arrays: base
        minus tombstones plus inserts (what ``TripleStore.build`` of it
        would index — the byte-identity reference)."""
        r = self.n_terms
        live = np.ones(self.n_base, bool)
        live[self.h_tomb_pos_ps] = False
        return (np.concatenate([self.h_s_pso[live],
                                self.h_ins_s_pso]).astype(np.int64),
                np.concatenate([self.h_key_ps[live] // r,
                                self.h_ins_key_ps // r]),
                np.concatenate([self.h_o_pso[live],
                                self.h_ins_o_pso]).astype(np.int64))

    def compact(self) -> int:
        """Fold the delta into the base: one full re-sort of the logical
        triple set.  The content is unchanged, so the bump logs an empty
        touched-predicate set.  Returns the new epoch (unchanged when the
        delta is empty)."""
        if not self._ins_set and not self._tomb_set:
            return self.epoch
        s, p, o = self.merged_triples()
        rebuilt = TripleStore.build(s, p, o, n_terms=self.n_terms,
                                    n_predicates=self.n_predicates)
        for f in _HOST_FIELDS:
            setattr(self, f, getattr(rebuilt, f))
        self.n_base = rebuilt.n_triples
        self._ins_set = set()
        self._tomb_set = set()
        self._rebuild_delta()
        self.base_epoch += 1
        return self._bump(frozenset(), delta_only=False)

    def maybe_compact(self, frac: float = 0.25, floor: int = 0) -> bool:
        """Compact when the delta reached ``max(frac * n_base, floor)``;
        returns True when a compaction ran."""
        if self.delta_size == 0:
            return False
        if self.delta_size < max(frac * self.n_base, floor, 1):
            return False
        self.compact()
        return True

    # ------------------------------------------------- host planning helpers
    def pred_run(self, p: int) -> tuple[int, int]:
        """Run [lo, hi) of predicate ``p`` in *base* PSO (== POS) order."""
        return int(self.h_pred_offsets[p]), int(self.h_pred_offsets[p + 1])

    def ps_run(self, p: int, s: int) -> tuple[int, int]:
        """Run [lo, hi) of (p, s, ?o) *base* rows in PSO order."""
        key = np.int64(p) * self.n_terms + s
        lo = int(np.searchsorted(self.h_key_ps, key, side="left"))
        hi = int(np.searchsorted(self.h_key_ps, key, side="right"))
        return lo, hi

    def po_run(self, p: int, o: int) -> tuple[int, int]:
        """Run [lo, hi) of (?s, p, o) *base* rows in POS order."""
        key = np.int64(p) * self.n_terms + o
        lo = int(np.searchsorted(self.h_key_po, key, side="left"))
        hi = int(np.searchsorted(self.h_key_po, key, side="right"))
        return lo, hi

    def _tombs_in(self, pos: np.ndarray, lo: int, hi: int) -> int:
        return int(np.searchsorted(pos, hi, side="left")
                   - np.searchsorted(pos, lo, side="left"))

    def _ins_count_ps(self, key_lo: int, key_hi: int) -> int:
        return int(np.searchsorted(self.h_ins_key_ps, key_hi, side="left")
                   - np.searchsorted(self.h_ins_key_ps, key_lo, side="left"))

    def tp_cardinality(self, p: int, s: int | None = None,
                       o: int | None = None) -> int:
        """Exact *logical* cardinality of a bound-predicate triple pattern
        (base minus tombstones plus inserts — what a rebuilt store would
        report, so plan ordering matches it).  The Def. 6 ``void:triples``
        metadata value (here exact, i.e. the F-specific threshold
        eps = 0)."""
        if s is not None and o is not None:
            lo, hi = self.ps_run(p, s)
            base = int(np.searchsorted(self.h_o_pso[lo:hi], o, side="right")
                       - np.searchsorted(self.h_o_pso[lo:hi], o, side="left"))
            t = (int(p), int(s), int(o))
            return base - (t in self._tomb_set) + (t in self._ins_set)
        if s is not None:
            lo, hi = self.ps_run(p, s)
            key = np.int64(p) * self.n_terms + s
            return (hi - lo) - self._tombs_in(self.h_tomb_pos_ps, lo, hi) \
                + self._ins_count_ps(key, key + 1)
        if o is not None:
            lo, hi = self.po_run(p, o)
            key = np.int64(p) * self.n_terms + o
            ins = int(np.searchsorted(self.h_ins_key_po, key + 1, "left")
                      - np.searchsorted(self.h_ins_key_po, key, "left"))
            return (hi - lo) - self._tombs_in(self.h_tomb_pos_po, lo, hi) \
                + ins
        lo, hi = self.pred_run(p)
        key = np.int64(p) * self.n_terms
        return (hi - lo) - self._tombs_in(self.h_tomb_pos_ps, lo, hi) \
            + self._ins_count_ps(key, key + np.int64(self.n_terms))

    def max_ins_degrees(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-predicate max insert-run lengths, (p, s)-keyed and
        (p, o)-keyed — the delta term of the capacity planner's degree
        oracle (a merged run is at most base max + insert max long, since
        tombstones only shrink runs).  Delta-sized host work."""
        out_ps = np.zeros(self.n_predicates + 1, np.int64)
        out_po = np.zeros(self.n_predicates + 1, np.int64)
        for keys, out in ((self.h_ins_key_ps, out_ps),
                          (self.h_ins_key_po, out_po)):
            if keys.shape[0]:
                uniq, counts = np.unique(keys, return_counts=True)
                np.maximum.at(out, (uniq // self.n_terms).astype(np.int64),
                              counts)
        return out_ps, out_po
