"""Seeded write windows for the live store.

The mix follows the append-feed generator of the JAX reference's
live-ingest benchmark (``benchmarks/common.py``, ``fig_live_ingest``):
each window is a batch of ``rate`` times the live store, half deletes
drawn uniformly from live triples and half inserts, spread over a few
populated predicates.  Two things differ, so that the writes land on the
read path and change answers:

- ``READ_SHARE`` of each window goes to the *read* predicates (the
  constant predicates of the query loads being served) and the rest to
  the ``N_FEED`` most populated predicates outside them — or to the read
  predicates too where no predicate lies outside them (the paper's
  10M-triple WatDiv store has 33 predicates, and 3 queries of each of
  the five loads name all 33);
- an insert takes a live ``(s, p)`` of its predicate and an object drawn
  from that predicate's live objects, so inserts interleave inside the
  runs the queries probe (the reference draws uniform ids);

and, from the second window on, ``CHURN`` of each window re-inserts the
previous window's deletes and as much again deletes its inserts, which
exercises resurrection and cancellation at scale.
"""

from __future__ import annotations

import numpy as np


READ_SHARE = 0.5  # share of a window on the read predicates
N_FEED = 2  # most populated predicates outside the read set
CHURN = 0.05  # share re-inserting (and again re-deleting) the last window


class WriteFeed:
    """Successive write windows over a live ``TripleStore``, each
    ``rate`` times its live size, made by one seeded numpy generator.
    ``next_window()`` reads the store's current logical triple set and
    returns ``dict(insert=(s, p, o), delete=(s, p, o))`` for
    ``store.apply_delta``."""

    def __init__(self, store, read_preds, rate: float = 0.01, seed: int = 0):
        self.store = store
        self.rate = rate
        self.rng = np.random.default_rng(seed)
        self.read_preds = np.array(sorted(set(int(p) for p in read_preds)),
                                   np.int64)
        counts = np.diff(store.h_pred_offsets[:store.n_predicates + 1])
        order = np.argsort(-counts, kind="stable")
        read = set(self.read_preds.tolist())
        self.feed_preds = np.array(
            [p for p in order if p not in read and counts[p] > 0][:N_FEED],
            np.int64)
        self._prev = None  # (deleted, inserted) (s, p, o) of the last window

    def _group(self, ms, mp, mo, preds, n_del, n_ins):
        """``n_del`` uniform live deletes and ``n_ins`` interleaving
        inserts over the predicates ``preds``."""
        pool = np.nonzero(np.isin(mp, preds))[0]
        if pool.size == 0:
            empty = np.zeros(0, np.int64)
            return (empty,) * 3, (empty,) * 3
        d = self.rng.choice(pool, min(n_del, pool.size), replace=False)
        # a live (s, p), then an object of p's live objects: sort the pool
        # by predicate and draw inside the picked predicate's segment
        by_p = pool[np.argsort(mp[pool], kind="stable")]
        p_sorted = mp[by_p]
        anchor = self.rng.choice(pool, n_ins)
        p_ins = mp[anchor]
        lo = np.searchsorted(p_sorted, p_ins, side="left")
        hi = np.searchsorted(p_sorted, p_ins, side="right")
        pick = lo + (self.rng.random(n_ins) * (hi - lo)).astype(np.int64)
        return ((ms[d], mp[d], mo[d]),
                (ms[anchor], p_ins, mo[by_p[pick]]))

    def next_window(self) -> dict:
        ms, mp, mo = self.store.merged_triples()
        n = max(2, int(round(self.rate * ms.shape[0])))
        n_del, n_ins = n // 2, n - n // 2
        n_churn = int(CHURN * n) if self._prev is not None else 0
        fresh_del, fresh_ins = n_del - n_churn, n_ins - n_churn
        # with no populated predicate outside the read set (a small
        # store), the whole window goes to the read predicates
        share = READ_SHARE if self.feed_preds.size else 1.0
        r_del = int(round(share * fresh_del))
        r_ins = int(round(share * fresh_ins))
        dels, inss = [], []
        for preds, nd, ni in ((self.read_preds, r_del, r_ins),
                              (self.feed_preds, fresh_del - r_del,
                               fresh_ins - r_ins)):
            d, i = self._group(ms, mp, mo, preds, nd, ni)
            dels.append(d)
            inss.append(i)
        if n_churn:
            prev_del, prev_ins = self._prev
            for src, out in ((prev_del, inss), (prev_ins, dels)):
                k = self.rng.choice(src[0].shape[0],
                                    min(n_churn, src[0].shape[0]),
                                    replace=False)
                out.append(tuple(a[k] for a in src))
        delete = tuple(np.concatenate([d[c] for d in dels]) for c in range(3))
        insert = tuple(np.concatenate([i[c] for i in inss]) for c in range(3))
        self._prev = (delete, insert)
        return dict(insert=insert, delete=delete)
