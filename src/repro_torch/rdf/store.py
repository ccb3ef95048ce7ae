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

This is the static store.  ``StoreArrays`` already carries the ten delta
columns of the live overlay, always zero-length here: an empty delta is
the "no delta" case every branch evaluator takes.
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
    """Device-resident index tensors.

    The delta tensors mirror the live overlay's layout (inserts in both
    orders, tombstone positions and their ``pos - rank`` columns).  This
    store has no overlay, so all ten are zero-length.
    """

    # PSO order (base)
    key_ps_pso: torch.Tensor  # int64[n]  p*R_term + s, ascending
    s_pso: torch.Tensor  # int32[n]
    o_pso: torch.Tensor  # int32[n]
    # POS order (base)
    key_po_pos: torch.Tensor  # int64[n]  p*R_term + o, ascending
    s_pos: torch.Tensor  # int32[n]
    o_pos: torch.Tensor  # int32[n]  (object of each POS row; run-constant)
    # delta: inserts, PSO order
    ins_key_ps: torch.Tensor  # int64[0]
    ins_s_pso: torch.Tensor  # int32[0]
    ins_o_pso: torch.Tensor  # int32[0]
    # delta: inserts, POS order
    ins_key_po: torch.Tensor  # int64[0]
    ins_s_pos: torch.Tensor  # int32[0]
    ins_o_pos: torch.Tensor  # int32[0]
    # delta: tombstones
    tomb_pos_ps: torch.Tensor  # int32[0]
    tomb_adj_ps: torch.Tensor  # int32[0]
    tomb_pos_po: torch.Tensor  # int32[0]
    tomb_adj_po: torch.Tensor  # int32[0]


_DELTA_DTYPES = (torch.int64, torch.int32, torch.int32,
                 torch.int64, torch.int32, torch.int32,
                 torch.int32, torch.int32, torch.int32, torch.int32)


@dataclass
class TripleStore:
    """Dictionary-id triple store: immutable PSO/POS index.

    The ``h_*`` arrays are the host index; ``device_arrays(device)``
    uploads it once per device and epoch.
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
    # mutation epoch: folded into the capacity planner's high-water-mark
    # keys, so observations made against other contents never alias
    epoch: int = 0
    # device views, keyed by torch.device, each tagged with its epoch
    _device: dict = field(default_factory=dict, repr=False)

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
    def from_host_arrays(arrays, n_terms: int,
                         n_predicates: int) -> "TripleStore":
        """A store over an existing numpy index, as another build of it
        wrote it out.

        ``arrays`` maps the seven host index names (``h_key_ps``,
        ``h_s_pso``, ``h_o_pso``, ``h_key_po``, ``h_s_pos``, ``h_o_pos``,
        ``h_pred_offsets``) to numpy arrays laid out as ``build`` lays them
        out.  Types are pinned (keys and offsets int64, values int32) and
        shapes checked; the sort order is trusted, as ``build``'s is.
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
        return TripleStore(n_triples=int(n), n_terms=int(n_terms),
                           n_predicates=int(n_predicates), **host)

    # ------------------------------------------------------------- device view
    def device_arrays(self, device=None) -> StoreArrays:
        """The index as tensors on ``device`` (default ``"cuda"``; raises
        where there is no card unless the caller passes ``"cpu"``).

        The counterpart of the JAX store's ``device`` property.  Uploaded
        once per device and epoch; on the CPU the tensors share memory
        with the host arrays.
        """
        dev = resolve_device(device)
        cached = self._device.get(dev)
        if cached is not None and cached[0] == self.epoch:
            return cached[1]
        base = [torch.from_numpy(getattr(self, f)).to(dev)
                for f in _HOST_FIELDS[:6]]
        delta = [torch.zeros(0, dtype=dt, device=dev) for dt in _DELTA_DTYPES]
        arrays = StoreArrays(*base, *delta)
        self._device[dev] = (self.epoch, arrays)
        return arrays

    @property
    def radix(self) -> int:
        return self.n_terms

    # ------------------------------------------------- host planning helpers
    def pred_run(self, p: int) -> tuple[int, int]:
        """Run [lo, hi) of predicate ``p`` in PSO (== POS) order."""
        return int(self.h_pred_offsets[p]), int(self.h_pred_offsets[p + 1])

    def ps_run(self, p: int, s: int) -> tuple[int, int]:
        """Run [lo, hi) of (p, s, ?o) rows in PSO order."""
        key = np.int64(p) * self.n_terms + s
        lo = int(np.searchsorted(self.h_key_ps, key, side="left"))
        hi = int(np.searchsorted(self.h_key_ps, key, side="right"))
        return lo, hi

    def po_run(self, p: int, o: int) -> tuple[int, int]:
        """Run [lo, hi) of (?s, p, o) rows in POS order."""
        key = np.int64(p) * self.n_terms + o
        lo = int(np.searchsorted(self.h_key_po, key, side="left"))
        hi = int(np.searchsorted(self.h_key_po, key, side="right"))
        return lo, hi

    def tp_cardinality(self, p: int, s: int | None = None,
                       o: int | None = None) -> int:
        """Exact cardinality of a bound-predicate triple pattern — the
        Def. 6 ``void:triples`` metadata value (here exact, i.e. the
        F-specific threshold eps = 0)."""
        if s is not None and o is not None:
            lo, hi = self.ps_run(p, s)
            return int(np.searchsorted(self.h_o_pso[lo:hi], o, side="right")
                       - np.searchsorted(self.h_o_pso[lo:hi], o, side="left"))
        if s is not None:
            lo, hi = self.ps_run(p, s)
            return hi - lo
        if o is not None:
            lo, hi = self.po_run(p, o)
            return hi - lo
        lo, hi = self.pred_run(p)
        return hi - lo
