"""LRU row cache: hot cohort rows skip the store round trip (the port's
copy of ``commefficient_tpu/clientstore/cache.py``).

Availability models make some clients far more frequent than others
(fedsim's cohort, sine and poisson draws), so a small set of hot rows kept
on the device skips both the bank read (disk pages under the mmap store)
and the copy to the card. The cache does not look at its values (the
streamer caches device rows, the tests numpy ones) and keeps exactly the
bookkeeping:

  * LRU order under a hard row capacity;
  * write-through on eviction: a DIRTY row leaving the cache goes to the
    ``writeback(cid, row)`` callback first, so the bank together with the
    dirty cached rows is always the whole state;
  * hit, miss and eviction counters for the ``clientstore/*`` scalars.

Not thread-safe by itself: the CohortStreamer holds its lock around it.
"""

from __future__ import annotations

from collections import OrderedDict


class LRURowCache:
    """Rows keyed by client id: ``get`` counts and refreshes recency,
    ``put`` inserts or overwrites and evicts the least recently used rows
    past capacity, dirty ones written through to ``writeback``."""

    def __init__(self, capacity: int, writeback):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._writeback = writeback
        self._rows: OrderedDict = OrderedDict()  # cid -> row
        self._dirty: set = set()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._rows)

    def __contains__(self, cid) -> bool:
        return cid in self._rows

    def get(self, cid):
        """The row, or None on a miss; a hit makes ``cid`` the most
        recently used."""
        row = self._rows.get(cid)
        if row is None:
            self.misses += 1
            return None
        self._rows.move_to_end(cid)
        self.hits += 1
        return row

    def put(self, cid, row, dirty: bool = True) -> None:
        """Insert or overwrite ``cid``'s row as the most recently used,
        then evict past capacity (a dirty row is written through
        first)."""
        self._rows[cid] = row
        self._rows.move_to_end(cid)
        if dirty:
            self._dirty.add(cid)
        else:
            self._dirty.discard(cid)
        while len(self._rows) > self.capacity:
            old_cid, old_row = self._rows.popitem(last=False)
            self.evictions += 1
            if old_cid in self._dirty:
                self._dirty.discard(old_cid)
                self._writeback(old_cid, old_row)

    def flush(self) -> None:
        """Write every dirty row through; the rows stay cached, clean."""
        for cid in [c for c in self._rows if c in self._dirty]:
            self._writeback(cid, self._rows[cid])
        self._dirty.clear()

    def invalidate(self) -> None:
        """Drop every row WITHOUT a writeback: after a whole-bank load (a
        checkpoint restore, a rollback) the cached rows are stale, and
        writing them back would bring the rolled-back state back."""
        self._rows.clear()
        self._dirty.clear()
